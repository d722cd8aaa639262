# -*- coding: utf-8 -*-
"""Bug-report bundle: stage the sync artifacts and pack them into an archive.

Parity surface (ffsubsync/ffsubsync.py:61-101): same bundle contents (session
log, first input, synced output when the sync succeeded, the reference
subtitle or the serialized speech npz), same staging-directory naming, same
preferred archive-format order. The implementation is manifest-driven: the
contents are decided up front as data, then staged and packed in one pass.
"""
import logging
import os
import shutil
from argparse import Namespace
from datetime import datetime
from typing import List, Optional, Tuple

from ffsubsync_tpu_torch.constants import SUBTITLE_EXTENSIONS
from ffsubsync_tpu_torch.validation import reference_format

logger: logging.Logger = logging.getLogger(__name__)

LOG_BASENAME = "ffsubsync.log"

# most- to least-preferred; the first one this python supports wins
_ARCHIVE_FORMATS = ("gztar", "bztar", "xztar", "zip", "tar")


def session_log_path(log_dir_path: Optional[str]) -> str:
    """The session log lands in ``log_dir_path`` when that is a real
    directory, else the current directory."""
    if log_dir_path is not None and os.path.isdir(log_dir_path):
        return os.path.join(log_dir_path, LOG_BASENAME)
    return LOG_BASENAME


def _supported_archive_format() -> Optional[str]:
    available = {name for name, _ in shutil.get_archive_formats()}
    for fmt in _ARCHIVE_FORMATS:
        if fmt in available:
            return fmt
    return None


def _bundle_manifest(
    args: Namespace, npy_savename: str, sync_was_successful: bool
) -> List[Tuple[str, bool]]:
    """``(path, relocate)`` pairs to stage; ``relocate`` moves instead of
    copying (for artifacts that only exist for the bundle's sake)."""
    manifest = [
        (session_log_path(args.log_dir_path), False),
        (args.srtin[0], False),
    ]
    if sync_was_successful:
        manifest.append((args.srtout, True))
    if reference_format(args.reference) in SUBTITLE_EXTENSIONS:
        manifest.append((args.reference, False))
    else:
        # the npz stays behind only when the user asked for it explicitly
        # (or it already WAS the reference)
        keep = args.serialize_speech or args.reference == npy_savename
        manifest.append((npy_savename, not keep))
    return manifest


def make_test_case(
    args: Namespace, npy_savename: Optional[str], sync_was_successful: bool
) -> int:
    """Pack the artifacts of this sync into ``<reference>.<timestamp>.tar.gz``
    (or the best supported format). Returns a process exit code."""
    if npy_savename is None:
        raise ValueError("need non-null npy_savename")
    staging = "{}.{}".format(
        args.reference, datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    )
    logger.info("creating test archive %s.tar.gz...", staging)
    archive_format = _supported_archive_format()
    if archive_format is None:
        logger.error(
            "failed to create test archive; no formats supported "
            "(this should not happen)"
        )
        return 1
    os.mkdir(staging)
    try:
        for path, relocate in _bundle_manifest(
            args, npy_savename, sync_was_successful
        ):
            transfer = shutil.move if relocate else shutil.copy
            transfer(path, staging)
        shutil.make_archive(staging, archive_format, os.curdir, staging)
        logger.info("...done")
    finally:
        shutil.rmtree(staging)
    return 0
