# -*- coding: utf-8 -*-
"""Sync orchestration for the PyTorch port: reference dispatch, candidate
search, output (counterpart of ``ffsubsync_tpu/sync.py``).

The host-side helpers (argument validation, candidate-source factories,
the framerate grid, the quality gate, gss bracket math, subtitle-stream
extraction, logging and test-case plumbing) are verbatim copies of the JAX
package's. What differs is where the device work goes: audio references
run through this port's
:class:`~ffsubsync_tpu_torch.media.audio.VideoSpeechSource` on the device
that ``FFS_TORCH_DEVICE`` names (resolved once, in
:func:`make_reference_extractor`), and candidates are scored by this port's
:func:`~ffsubsync_tpu_torch.ops.align.align_candidates`. Subtitle, ``.npz``
and PGS references stay on the host, as in the reference.
"""
import argparse
import logging
import os
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ffsubsync_tpu_torch.cli import make_parser
from ffsubsync_tpu_torch.constants import (
    DEFAULT_ENCODING,
    DEFAULT_VAD,
    FRAMERATE_RATIOS,
    SAMPLE_RATE,
    SUBTITLE_EXTENSIONS,
)
from ffsubsync_tpu_torch.media.ffmpeg import ffmpeg_bin_path
from ffsubsync_tpu_torch.ops.align import (
    Alignment,
    FailedToFindAlignmentException,
    align_candidates,
)
from ffsubsync_tpu_torch.speech import (
    DeserializeSpeechSource,
    SubtitleSpeechSource,
    make_subtitle_speech_source,
)
from ffsubsync_tpu_torch.subs.parser import make_subtitle_parser
from ffsubsync_tpu_torch.subs.transforms import merge_documents, shift_document
from ffsubsync_tpu_torch.utils.archive import make_test_case, session_log_path
from ffsubsync_tpu_torch.utils.progress import ProgressInfo
from ffsubsync_tpu_torch.validation import (
    reference_format as _ref_format,
    resolve_output_path as _resolve_srtout,
    speech_archive_path,
    validate_args,
    validate_file_permissions,
)

logger: logging.Logger = logging.getLogger(__name__)

MIN_FRAMERATE_RATIO = 0.9
MAX_FRAMERATE_RATIO = 1.1


def override(args: argparse.Namespace, **kwargs: Any) -> Dict[str, Any]:
    args_dict = dict(args.__dict__)
    args_dict.update(kwargs)
    return args_dict


def get_srt_source_maker(
    args: argparse.Namespace, srtin: Optional[str]
) -> Callable[[Optional[float]], Any]:
    """Candidate-source factory sharing one caching parser per input file."""
    if srtin is None:
        srtin_format = "srt"
    else:
        srtin_format = os.path.splitext(srtin)[-1][1:]
    parser = make_subtitle_parser(fmt=srtin_format, caching=True, **args.__dict__)
    return lambda scale_factor: make_subtitle_speech_source(
        scale_factor,
        fmt=srtin_format,
        encoding=args.encoding,
        max_subtitle_seconds=args.max_subtitle_seconds,
        start_seconds=args.start_seconds,
        parser=parser,
    )


def get_framerate_ratios_to_try(args: argparse.Namespace) -> List[Optional[float]]:
    """Candidate framerate scale factors for the grid search.

    Each known conversion ratio is tried in both directions (the subtitles may
    be faster OR slower than the media); a trailing ``None`` slot requests the
    continuous gss refinement when ``--gss`` is on. Empty under
    ``--no-fix-framerate``. The ORDER is contract surface, not style: the
    best candidate is chosen by first-maximum, so on an exact score tie the
    list position decides the scale factor — all forward ratios precede all
    inverses, as in ffsubsync/ffsubsync.py:131-142.
    """
    if args.no_fix_framerate:
        return []
    grid: List[Optional[float]] = list(FRAMERATE_RATIOS) + [
        1.0 / ratio for ratio in FRAMERATE_RATIOS
    ]
    if args.gss:
        grid.append(None)
    return grid


def assess_alignment_quality(
    best_score: float,
    offset_seconds: float,
    scale_factor: float,
    *,
    min_score: float,
    max_offset_seconds: float,
    max_framerate_deviation: float,
) -> List[str]:
    """Reasons an alignment looks too low-quality to trust (empty = trust it).

    Rule table mirroring the reference gate (ffsubsync/ffsubsync.py:145-174):
    an anti-correlated best score, an implausibly large shift, or a framerate
    scale far from 1.0 each suggest a spurious match. Threshold values and the
    human-readable reason strings are contract surface
    (tests/test_quality_gate.py).
    """
    framerate_deviation = abs(scale_factor - 1.0)
    rules = (
        (
            best_score < min_score,
            "score %.1f < %.1f" % (best_score, min_score),
        ),
        (
            abs(offset_seconds) > max_offset_seconds,
            "|offset| %.1fs > %.1fs" % (abs(offset_seconds), max_offset_seconds),
        ),
        (
            framerate_deviation > max_framerate_deviation,
            "framerate deviation %.3f > %.3f"
            % (framerate_deviation, max_framerate_deviation),
        ),
    )
    return [reason for failed, reason in rules if failed]


GSS_TOL = 1e-4  # same tolerance as the reference (golden_section_search.py:15)
_GSS_GRID_K = 33  # ratios scored per refinement round (one device launch)


def gss_grid(lo: float, hi: float) -> Tuple[float, List[float]]:
    """One refinement round's ratio grid over bracket [lo, hi].

    Shared by the single-file loop below and batch.sync_batch's per-job
    refinement so the two entry points use provably identical bracket math.
    """
    step = (hi - lo) / (_GSS_GRID_K - 1)
    return step, [lo + i * step for i in range(_GSS_GRID_K)]


def gss_narrow(ratios: List[float], step: float, best_i: int) -> Tuple[float, float]:
    """Bracket for the next round: one step either side of the argmax,
    clamped to the reference's [0.9, 1.1] search range."""
    return (
        max(MIN_FRAMERATE_RATIO, ratios[best_i] - step),
        min(MAX_FRAMERATE_RATIO, ratios[best_i] + step),
    )


def _run_gss_search(
    ref_sig: Any,
    source_maker: Callable[[Optional[float]], Any],
    srtin: Optional[str],
    max_offset_samples: Optional[int],
    prefer_host: bool = False,
    device=None,
) -> List[Tuple[Alignment, SubtitleSpeechSource]]:
    """Batched grid refinement of the framerate ratio: each round scores a
    33-ratio grid in one search and narrows the bracket around the argmax
    until the step is below ``GSS_TOL``; every candidate of the last round
    enters the cross-candidate selection (``ffsubsync_tpu`` ``sync.py``)."""
    lo, hi = MIN_FRAMERATE_RATIO, MAX_FRAMERATE_RATIO
    while True:
        step, ratios = gss_grid(lo, hi)
        sources = [source_maker(r).fit(srtin) for r in ratios]
        alignments = align_candidates(
            ref_sig,
            [s.spec_ for s in sources],
            max_offset_samples=max_offset_samples,
            prefer_host=prefer_host,
            device=device,
        )
        best_i = int(np.argmax([a.score for a in alignments]))
        logger.info(
            "gss grid [%.5f, %.5f]: best ratio %.5f (score %.0f, offset %d)",
            lo, hi, ratios[best_i], alignments[best_i].score,
            alignments[best_i].offset,
        )
        if step <= GSS_TOL:
            return list(zip(alignments, sources))
        lo, hi = gss_narrow(ratios, step, best_i)


def try_sync(
    args: argparse.Namespace, ref_extractor: Optional[Any], result: Dict[str, Any]
) -> bool:
    """The per-srtin sync loop with its quality gate, as in the reference
    (ffsubsync/ffsubsync.py:177-300); scoring goes to this port's aligner."""
    result["sync_was_successful"] = False
    sync_was_successful = True
    logger.info(
        "extracting speech segments from %s...",
        "stdin" if not args.srtin else "subtitles file(s) {}".format(args.srtin),
    )
    if not args.srtin:
        args.srtin = [None]
    device = getattr(ref_extractor, "device", None)
    for srtin in args.srtin:
        try:
            skip_sync = args.skip_sync or ref_extractor is None
            skip_infer_framerate_ratio = (
                args.skip_infer_framerate_ratio or ref_extractor is None
            )
            srtout = _resolve_srtout(args, srtin)
            source_maker = get_srt_source_maker(args, srtin)
            framerate_ratios = get_framerate_ratios_to_try(args)
            has_gss = any(r is None for r in framerate_ratios)
            grid_ratios = [1.0] + [r for r in framerate_ratios if r is not None]
            sources = [source_maker(r) for r in grid_ratios]
            for source in sources:
                source.fit(srtin)
            inferred_source: Optional[SubtitleSpeechSource] = None
            if (
                not skip_infer_framerate_ratio
                and getattr(ref_extractor, "num_frames", None) is not None
            ):
                inferred_framerate_ratio_from_length = (
                    float(ref_extractor.num_frames) / sources[0].num_frames
                )
                # "frameratio ratio" is the reference's own log string
                logger.info(
                    "inferred frameratio ratio: %.3f"
                    % inferred_framerate_ratio_from_length
                )
                inferred_source = source_maker(
                    inferred_framerate_ratio_from_length
                ).fit(srtin)
                logger.info("...done")
            logger.info("computing alignments...")
            if skip_sync:
                best_score = 0.0
                best_source = sources[0]
                offset_samples = 0
            else:
                ref_sig = ref_extractor.signal_or_spec()
                prefer_host = bool(getattr(ref_extractor, "prefer_host_align", False))
                max_offset_samples = abs(int(args.max_offset_seconds * SAMPLE_RATE))
                batch = list(sources)
                if inferred_source is not None:
                    batch.append(inferred_source)
                alignments = align_candidates(
                    ref_sig,
                    [s.spec_ for s in batch],
                    max_offset_samples=max_offset_samples,
                    prefer_host=prefer_host,
                    device=device,
                )
                # selection order parity: grid, then gss records, then inferred
                scored: List[Tuple[Alignment, SubtitleSpeechSource]] = list(
                    zip(alignments[: len(sources)], sources)
                )
                if has_gss:
                    scored.extend(
                        _run_gss_search(
                            ref_sig, source_maker, srtin, max_offset_samples,
                            prefer_host=prefer_host, device=device,
                        )
                    )
                if inferred_source is not None:
                    scored.append((alignments[-1], inferred_source))
                eligible = [
                    (a, s) for a, s in scored if abs(a.offset) <= max_offset_samples
                ]
                if len(eligible) == 0:
                    raise FailedToFindAlignmentException(
                        "Synchronization failed; consider passing "
                        "--max-offset-seconds with a number larger than "
                        "{}".format(args.max_offset_seconds)
                    )
                best_alignment, best_source = max(eligible, key=lambda x: x[0].score)
                best_score = best_alignment.score
                offset_samples = best_alignment.offset
            if best_score < 0:
                sync_was_successful = False
            logger.info("...done")
            offset_seconds = (
                offset_samples / float(SAMPLE_RATE) + args.apply_offset_seconds
            )
            scale_factor = best_source.scale_factor
            logger.info("score: %.3f", best_score)
            logger.info("offset seconds: %.3f", offset_seconds)
            logger.info("framerate scale factor: %.3f", scale_factor)
            low_quality_reasons: List[str] = []
            if getattr(args, "skip_sync_on_low_quality", False):
                low_quality_reasons = assess_alignment_quality(
                    best_score,
                    offset_seconds,
                    scale_factor,
                    min_score=args.min_score,
                    max_offset_seconds=args.quality_max_offset_seconds,
                    max_framerate_deviation=args.max_framerate_deviation,
                )
            if low_quality_reasons:
                logger.warning(
                    "low-quality alignment (%s); leaving subtitles unmodified",
                    "; ".join(low_quality_reasons),
                )
                sync_was_successful = False
                original_subs = best_source.parsed_doc_
                out_subs = original_subs.clone_props_for_subs(list(original_subs))
                if args.output_encoding != "same":
                    out_subs = out_subs.set_encoding(args.output_encoding)
                logger.info("writing original (unsynced) output to %s", srtout or "stdout")
                out_subs.write_file(srtout)
                continue
            out_subs = shift_document(best_source.scaled_doc_, offset_seconds)
            if args.merge_with_reference:
                out_subs = merge_documents(
                    out_subs, ref_extractor.parsed_doc_, first="reference"
                )
            if args.output_encoding != "same":
                out_subs = out_subs.set_encoding(args.output_encoding)
            suppress_output_thresh = args.suppress_output_if_offset_less_than
            if offset_seconds >= (suppress_output_thresh or float("-inf")):
                logger.info("writing output to %s", srtout or "stdout")
                out_subs.write_file(srtout)
            else:
                logger.warning(
                    "suppressing output because offset %s was less than "
                    "suppression threshold %s",
                    offset_seconds,
                    args.suppress_output_if_offset_less_than,
                )
        except Exception:
            sync_was_successful = False
            logger.exception("failed to sync %s", srtin)
        else:
            result["offset_seconds"] = offset_seconds
            result["framerate_scale_factor"] = scale_factor
    result["sync_was_successful"] = sync_was_successful
    return sync_was_successful


def make_reference_extractor(
    args: argparse.Namespace,
    progress_handler: Optional[Callable[[ProgressInfo], None]] = None,
) -> Any:
    """Dispatch the reference to a speech source (parity: ffsubsync.py:
    303-400): PGS stream > subtitle extension > serialized npy/npz >
    video/audio. Only the video/audio source touches the device."""
    pgs_stream = getattr(args, "pgs_ref_stream", None)
    if pgs_stream is not None:
        from ffsubsync_tpu_torch.media.pgs import PGSSpeechSource

        resolved_stream: Optional[str] = None if pgs_stream == "auto" else pgs_stream
        if resolved_stream is not None and not resolved_stream.startswith("0:"):
            resolved_stream = "0:" + resolved_stream
        return PGSSpeechSource(
            sample_rate=SAMPLE_RATE,
            start_seconds=args.start_seconds,
            ffmpeg_path=args.ffmpeg_path,
            ref_stream=resolved_stream,
            gui_mode=args.gui_mode,
        )
    ref_format = _ref_format(args.reference)
    if ref_format in SUBTITLE_EXTENSIONS:
        if args.vad is not None:
            logger.warning("Vad specified, but reference was not a movie")
        return SubtitleSpeechSource(
            fmt=ref_format,
            encoding=args.reference_encoding or DEFAULT_ENCODING,
            caching=False,
            max_subtitle_seconds=args.max_subtitle_seconds,
            start_seconds=args.start_seconds,
            strict=getattr(args, "strict", False),
        )
    if ref_format in ("npy", "npz"):
        if args.vad is not None:
            logger.warning("Vad specified, but reference was not a movie")
        return DeserializeSpeechSource(args.non_speech_label)
    vad = args.vad or DEFAULT_VAD
    if args.reference_encoding is not None:
        logger.warning(
            "Reference srt encoding specified, but reference was a video file"
        )
    ref_stream = args.reference_stream
    if ref_stream is not None and not ref_stream.startswith("0:"):
        ref_stream = "0:" + ref_stream
    from ffsubsync_tpu_torch.device import get_device

    if getattr(args, "multi_segment_sync", False):
        from ffsubsync_tpu_torch.media.segments import MultiSegmentVideoSpeechSource

        return MultiSegmentVideoSpeechSource(
            vad=vad,
            sample_rate=SAMPLE_RATE,
            frame_rate=args.frame_rate,
            non_speech_label=args.non_speech_label,
            device=get_device(),
            segment_count=getattr(args, "segment_count", 8),
            skip_intro_outro=getattr(args, "skip_intro_outro", False),
            parallel_workers=getattr(args, "parallel_workers", 4),
            ffmpeg_path=args.ffmpeg_path,
            ref_stream=ref_stream,
            vlc_mode=args.vlc_mode,
            gui_mode=args.gui_mode,
        )
    from ffsubsync_tpu_torch.media.audio import VideoSpeechSource

    return VideoSpeechSource(
        vad=vad,
        sample_rate=SAMPLE_RATE,
        frame_rate=args.frame_rate,
        non_speech_label=args.non_speech_label,
        device=get_device(),
        start_seconds=args.start_seconds,
        ffmpeg_path=args.ffmpeg_path,
        ref_stream=ref_stream,
        vlc_mode=args.vlc_mode,
        gui_mode=args.gui_mode,
        max_duration_seconds=getattr(args, "max_duration_seconds", None),
        extract_audio_first=getattr(args, "extract_audio_first", False),
        progress_handler=progress_handler,
    )


def extract_subtitles_from_reference(args: argparse.Namespace) -> int:
    """`--extract-subs-from-stream`: no sync, just dump a subtitle track."""
    # normalize "N" / "s:N" / "0:s:N" to "0:s:N" (the reference mangles the
    # bare "s:N" form into an invalid "0:s:s:N" — ffsubsync.py:403-409 — which
    # ffmpeg then rejects; normalizing correctly is a deliberate fix)
    stream = args.extract_subs_from_stream
    if stream.startswith("s:"):
        stream = "0:" + stream
    elif not stream.startswith("0:s:"):
        stream = "0:s:{}".format(stream)
    if not stream.startswith("0:s:"):
        logger.error(
            "invalid stream for subtitle extraction: %s", args.extract_subs_from_stream
        )
    ffmpeg_args = [
        ffmpeg_bin_path("ffmpeg", args.gui_mode, ffmpeg_resources_path=args.ffmpeg_path)
    ]
    ffmpeg_args.extend(
        [
            "-y",
            "-nostdin",
            "-loglevel",
            "fatal",
            "-i",
            args.reference,
            "-map",
            "{}".format(stream),
            "-f",
            "srt",
        ]
    )
    if args.srtout is None:
        ffmpeg_args.append("-")
    else:
        ffmpeg_args.append(args.srtout)
    logger.info(
        "attempting to extract subtitles to %s ...",
        "stdout" if args.srtout is None else args.srtout,
    )
    retcode = subprocess.call(ffmpeg_args)
    if retcode == 0:
        logger.info("...done")
    else:
        logger.error(
            "ffmpeg unable to extract subtitles from reference; return code %d",
            retcode,
        )
    return retcode


def _setup_logging(
    args: argparse.Namespace,
) -> Tuple[Optional[str], Optional[logging.FileHandler]]:
    log_handler = None
    log_path = None
    if args.make_test_case or args.log_dir_path is not None:
        log_path = session_log_path(args.log_dir_path)
        log_handler = logging.FileHandler(log_path)
        logger.addHandler(log_handler)
        logger.info("this log will be written to %s", os.path.abspath(log_path))
    return log_path, log_handler


def _npy_savename(args: argparse.Namespace) -> str:
    return speech_archive_path(args.reference)


def _run_impl(
    args: argparse.Namespace,
    result: Dict[str, Any],
    progress_handler: Optional[Callable[[ProgressInfo], None]] = None,
) -> bool:
    if args.extract_subs_from_stream is not None:
        result["retval"] = extract_subtitles_from_reference(args)
        return True
    if args.srtin is not None and (
        args.reference is None
        or (len(args.srtin) == 1 and args.srtin[0] == args.reference)
    ):
        return try_sync(args, None, result)
    ref_extractor = make_reference_extractor(args, progress_handler=progress_handler)
    logger.info("extracting speech segments from reference '%s'...", args.reference)
    ref_extractor.fit(args.reference)
    logger.info("...done")
    if args.make_test_case or args.serialize_speech:
        logger.info("serializing speech...")
        np.savez_compressed(_npy_savename(args), speech=ref_extractor.transform())
        logger.info("...done")
        if not args.srtin:
            logger.info(
                "unsynchronized subtitle file not specified; "
                "skipping synchronization"
            )
            return False
    return try_sync(args, ref_extractor, result)


def validate_and_transform_args(
    parser_or_args: Union[argparse.ArgumentParser, argparse.Namespace],
) -> Optional[argparse.Namespace]:
    if isinstance(parser_or_args, argparse.Namespace):
        parser = None
        args = parser_or_args
    else:
        parser = parser_or_args
        args = parser.parse_args()
    try:
        validate_args(args)
    except ValueError as e:
        logger.error(e)
        if parser is not None:
            parser.print_usage()
        return None
    if args.gui_mode and args.srtout is None:
        args.srtout = "{}.synced.srt".format(os.path.splitext(args.srtin[0])[0])
    try:
        validate_file_permissions(args)
    except ValueError as e:
        logger.error(e)
        return None
    ref_format = _ref_format(args.reference)
    if args.merge_with_reference and ref_format not in SUBTITLE_EXTENSIONS:
        logger.error(
            "merging synced output with reference only valid "
            "when reference composed of subtitles"
        )
        return None
    return args


def run(
    parser_or_args: Union[argparse.ArgumentParser, argparse.Namespace],
    progress_handler: Optional[Callable[[ProgressInfo], None]] = None,
) -> Dict[str, Any]:
    """Synchronize subtitles; returns the result dict
    {retval, offset_seconds, framerate_scale_factor, sync_was_successful}.

    ``--profile-dir`` records a ``torch.profiler`` trace (CPU and, on the
    card, CUDA activity) of the whole sync as a Chrome trace in that
    directory.
    """
    sync_was_successful = False
    result: Dict[str, Any] = {
        "retval": 0,
        "offset_seconds": None,
        "framerate_scale_factor": None,
    }
    args = validate_and_transform_args(parser_or_args)
    if args is None:
        result["retval"] = 1
        return result
    log_path, log_handler = _setup_logging(args)
    try:
        profile_dir = getattr(args, "profile_dir", None)
        if profile_dir:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            logger.info("profiling device trace to %s", profile_dir)
            os.makedirs(profile_dir, exist_ok=True)
            with torch.profiler.profile(activities=activities) as prof:
                sync_was_successful = _run_impl(
                    args, result, progress_handler=progress_handler
                )
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        else:
            sync_was_successful = _run_impl(
                args, result, progress_handler=progress_handler
            )
        result["sync_was_successful"] = sync_was_successful
        return result
    finally:
        if log_handler is not None and log_path is not None:
            log_handler.close()
            logger.removeHandler(log_handler)
            if args.make_test_case:
                result["retval"] += make_test_case(
                    args, _npy_savename(args), sync_was_successful
                )
            if args.log_dir_path is None or not os.path.isdir(args.log_dir_path):
                os.remove(log_path)


def main() -> int:
    parser = make_parser()
    return run(parser)["retval"]


if __name__ == "__main__":
    sys.exit(main())
