# -*- coding: utf-8 -*-
"""CLI-contract validation and input auto-detection.

Decision parity with the reference driver's validation pass
(ffsubsync/ffsubsync.py:449-600): every accept/reject decision and every
error string (user-visible contract surface, pinned by the test suite) is
preserved. The organization is this project's own: an ordered table of
normalize/check rules, each owning one concern, applied by
:func:`validate_args`; file-permission checks are a declarative requirement
list walked by :func:`validate_file_permissions`.
"""
import logging
import os
import sys
from argparse import Namespace
from typing import Callable, Iterator, List, Optional, Tuple

from ffsubsync_tpu_torch.constants import is_remote_url

logger: logging.Logger = logging.getLogger(__name__)


def reference_format(ref_fname: Optional[str]) -> Optional[str]:
    """Extension (no dot) that routes the reference to its pipeline.

    The reference slices the last three characters (ffsubsync.py:55-58);
    splitting on the actual extension separator routes identically for every
    real format while not misfiring on dotless names.
    """
    if ref_fname is None:
        return None
    return os.path.splitext(ref_fname)[-1][1:]


def speech_archive_path(reference: str) -> str:
    """Where serialized reference speech lands (`<reference stem>.npz`)."""
    return os.path.splitext(reference)[0] + ".npz"


def resolve_output_path(args: Namespace, srtin: Optional[str]) -> Optional[str]:
    """Output precedence: overwrite-input > auto `.synced.srt` > explicit."""
    if args.overwrite_input:
        return srtin
    if getattr(args, "auto_srtout", False) and srtin is not None:
        return os.path.splitext(srtin)[0] + ".synced.srt"
    return args.srtout


def detect_sibling_subtitles(reference: str) -> List[str]:
    """Subtitle files next to the reference that share its name stem.

    `<stem>.srt` and `<stem>.<lang>.srt` qualify; previous `.synced.srt`
    outputs and the reference file itself never do (so re-runs stay
    idempotent and a subtitle reference can't match itself).
    """
    ref_dir = os.path.dirname(reference) or "."
    ref_stem = os.path.splitext(os.path.basename(reference))[0]
    ref_abs = os.path.abspath(reference)

    def qualifies(name: str) -> bool:
        stem, ext = os.path.splitext(name)
        return (
            ext.lower() == ".srt"
            and not name.endswith(".synced.srt")
            and (stem == ref_stem or stem.startswith(ref_stem + "."))
        )

    siblings = []
    for name in sorted(os.listdir(ref_dir)):
        if not qualifies(name):
            continue
        path = os.path.join(ref_dir, name)
        if os.path.abspath(path) != ref_abs:
            siblings.append(path)
    return siblings


# --------------------------------------------------------------------------
# argument rules (order matters: normalization before the checks that read it)
# --------------------------------------------------------------------------


def _silence_logging_for_vlc(args: Namespace) -> None:
    if args.vlc_mode:
        logging.getLogger("ffsubsync_tpu_torch").setLevel(logging.CRITICAL)


def _require_reference(args: Namespace) -> None:
    # pure offset application on existing inputs is the one referenceless mode
    if args.reference is not None:
        return
    if args.apply_offset_seconds == 0 or not args.srtin:
        raise ValueError(
            "`reference` required unless `--apply-offset-seconds` specified"
        )


def _normalize_offset_only_inputs(args: Namespace) -> None:
    if args.apply_offset_seconds == 0:
        return
    args.srtin = args.srtin or [args.reference]
    if not args.srtin:
        raise ValueError(
            "at least one of `srtin` or `reference` must be specified "
            "to apply offset seconds"
        )


def _check_multiple_inputs(args: Namespace) -> None:
    if len(args.srtin) <= 1:
        return
    if not args.overwrite_input:
        raise ValueError(
            "cannot specify multiple input srt files without overwriting"
        )
    if args.make_test_case:
        raise ValueError("cannot specify multiple input srt files for test cases")
    if args.gui_mode:
        raise ValueError("cannot specify multiple input srt files in GUI mode")


def _may_autodetect_inputs(args: Namespace) -> bool:
    return (
        args.reference is not None
        and not is_remote_url(args.reference)  # no directory to list remotely
        and args.extract_subs_from_stream is None
        and not args.gui_mode
        and not args.make_test_case
        # a non-tty stdin means subtitles are being piped in; leave them be
        and sys.stdin.isatty()
    )


def _autodetect_inputs(args: Namespace) -> None:
    logger.info("no input srt specified; detecting input srt from reference")
    detected = detect_sibling_subtitles(args.reference)
    if not detected:
        logger.info("no input srt detected from reference")
        return
    for path in detected:
        logger.info("detected input srt: %s", path)
    args.srtin = detected
    if len(detected) > 1 and args.srtout is not None:
        raise ValueError(
            "detected multiple input srt files but an output file was "
            "specified; re-run with --overwrite-input or a single input"
        )
    if args.srtout is None and not args.overwrite_input:
        args.auto_srtout = True
        logger.info(
            "writing synced output alongside each input as "
            "<name>.synced.srt; pass --overwrite-input to overwrite the "
            "input file(s) in place instead"
        )


def _resolve_inputs(args: Namespace) -> None:
    if args.srtin:
        _check_multiple_inputs(args)
    elif _may_autodetect_inputs(args):
        _autodetect_inputs(args)


def _check_test_case_io(args: Namespace) -> None:
    # gui mode fills in srtout later, so it skips this check
    if args.make_test_case and not args.gui_mode:
        if not args.srtin or args.srtout is None:
            raise ValueError(
                "need to specify input and output srt files for test cases"
            )


def _check_overwrite_mode(args: Namespace) -> None:
    if not args.overwrite_input:
        return
    if args.extract_subs_from_stream is not None:
        raise ValueError(
            "input overwriting not allowed for extracting subtitles "
            "from reference"
        )
    if not args.srtin:
        raise ValueError(
            "need to specify input srt if --overwrite-input "
            "is specified since we cannot overwrite stdin"
        )
    if args.srtout is not None:
        raise ValueError(
            "overwrite input set but output file specified; "
            "refusing to run in case this was not intended"
        )


def _check_extraction_mode(args: Namespace) -> None:
    if args.extract_subs_from_stream is None:
        return
    if args.make_test_case:
        raise ValueError("test case is for sync and not subtitle extraction")
    if args.srtin:
        raise ValueError(
            "stream specified for reference subtitle extraction; "
            "-i flag for sync input not allowed"
        )


_ARG_RULES: Tuple[Callable[[Namespace], None], ...] = (
    _silence_logging_for_vlc,
    _require_reference,
    _normalize_offset_only_inputs,
    _resolve_inputs,
    _check_test_case_io,
    _check_overwrite_mode,
    _check_extraction_mode,
)


def validate_args(args: Namespace) -> None:
    """Normalize and validate the parsed namespace in place.

    Raises ``ValueError`` with a user-facing message on the first violated
    rule (parity: ffsubsync.py:477-560).
    """
    for rule in _ARG_RULES:
        rule(args)


# --------------------------------------------------------------------------
# file-permission requirements
# --------------------------------------------------------------------------

_ACCESS_HINT = "; try ensuring file exists and has correct permissions"


def _readable(path: str) -> bool:
    return os.access(path, os.R_OK)


def _writable_if_present(path: str) -> bool:
    # a missing output is fine (it will be created); an existing one we
    # cannot write to is a guaranteed late failure, so reject up front
    return not os.path.exists(path) or os.access(path, os.W_OK)


def _access_requirements(
    args: Namespace,
) -> Iterator[Tuple[str, str, Callable[[str], bool]]]:
    """Yield ``(action-description, path, predicate)`` requirements."""
    if args.reference is not None and not is_remote_url(args.reference):
        # remote references stream straight through ffmpeg; nothing to stat
        yield "read reference", args.reference, _readable
    for srtin in args.srtin or []:
        if srtin is not None:
            yield "read input subtitles", srtin, _readable
    if args.srtout is not None:
        yield "write output subtitles", args.srtout, _writable_if_present


def validate_file_permissions(args: Namespace) -> None:
    """Fail fast on unreadable inputs / unwritable outputs
    (parity: ffsubsync.py:565-600)."""
    for action, path, satisfied in _access_requirements(args):
        if not satisfied(path):
            raise ValueError(
                "unable to {} {}{}".format(action, path, _ACCESS_HINT)
            )
    if args.make_test_case or args.serialize_speech:
        savename = speech_archive_path(args.reference)
        if not _writable_if_present(savename):
            raise ValueError(
                "unable to write test case file archive %s "
                "(try checking permissions)" % savename
            )
