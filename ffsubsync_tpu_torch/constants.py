# -*- coding: utf-8 -*-
"""Central tunables and defaults.

Semantics mirror the reference (ffsubsync/constants.py:5-69): the 100 Hz
speech-signal resolution, default 48 kHz decode rate, the discrete
framerate-ratio grid, and the quality-gate thresholds are all behavioral
contract surface that downstream tooling depends on.
"""
from typing import List, Optional, Tuple

SUBSYNC_RESOURCES_ENV_MAGIC: str = "ffsubsync_resources_xj48gjdkl340"

# The canonical intermediate representation is a float signal sampled at this
# rate: 1.0 = speech, `non_speech_label` = non-speech (10 ms windows).
SAMPLE_RATE: int = 100

# Discrete candidate framerate ratios (and, at call sites, their inverses):
# the three common film/PAL/NTSC speed-change factors.
FRAMERATE_RATIOS: List[float] = [24.0 / 23.976, 25.0 / 23.976, 25.0 / 24.0]

DEFAULT_FRAME_RATE: int = 48000
DEFAULT_NON_SPEECH_LABEL: float = 0.0
DEFAULT_ENCODING: str = "infer"
DEFAULT_MAX_SUBTITLE_SECONDS: int = 10
DEFAULT_START_SECONDS: int = 0
DEFAULT_SCALE_FACTOR: float = 1
DEFAULT_VAD: str = "subs_then_webrtc"
DEFAULT_MAX_OFFSET_SECONDS: int = 60
DEFAULT_APPLY_OFFSET_SECONDS: int = 0

# --multi-segment-sync sampling shape, shared by the CLI and batch manifests
# so the two entry points cannot drift apart.
DEFAULT_SEGMENT_COUNT: int = 8
DEFAULT_PARALLEL_WORKERS: int = 4

# Quality gating (--skip-sync-on-low-quality). The alignment score's sign is
# meaningful even though its magnitude is not normalized, so min-score 0.0
# rejects only anti-correlated alignments. The framerate-deviation default
# clears every discrete ratio correction (max ~0.0427) and typical --gss
# results, so by default no legitimate correction is rejected.
DEFAULT_MIN_SCORE: float = 0.0
DEFAULT_QUALITY_MAX_OFFSET_SECONDS: float = 30.0
DEFAULT_MAX_FRAMERATE_DEVIATION: float = 0.1

SUBTITLE_EXTENSIONS: Tuple[str, ...] = ("srt", "ass", "ssa", "sub")

# Remote URL protocols ffmpeg can read directly as an input (`-i <url>`), so a
# reference of this form needs no local download or read-permission check.
REMOTE_URL_PROTOCOLS: Tuple[str, ...] = (
    "http://",
    "https://",
    "rtmp://",
    "rtsp://",
    "ftp://",
)


def is_remote_url(path: Optional[str]) -> bool:
    """Return True if *path* is a remote URL ffmpeg can stream directly."""
    if path is None:
        return False
    return path.startswith(REMOTE_URL_PROTOCOLS)


PROJECT_NAME: str = "ffsubsync-tpu"
DESCRIPTION: str = "Synchronize subtitles with video (TPU-native)."
LONG_DESCRIPTION: str = (
    "Automatic and language-agnostic synchronization of subtitles with video, "
    "with the speech-signal and alignment compute running on TPU via JAX/XLA/Pallas."
)
