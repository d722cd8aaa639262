# -*- coding: utf-8 -*-
"""Command-line argument surface.

Flag names, defaults, hidden flags and help text semantics follow the
reference's parser (ffsubsync/ffsubsync.py:728-1034) so ``ffs`` invocations
are drop-in. TPU-specific extensions are kept in their own group and are
additive (no reference flag changes meaning).
"""
import argparse

from ffsubsync_tpu_torch.constants import (
    DEFAULT_APPLY_OFFSET_SECONDS,
    DEFAULT_ENCODING,
    DEFAULT_FRAME_RATE,
    DEFAULT_MAX_FRAMERATE_DEVIATION,
    DEFAULT_MAX_OFFSET_SECONDS,
    DEFAULT_MAX_SUBTITLE_SECONDS,
    DEFAULT_MIN_SCORE,
    DEFAULT_NON_SPEECH_LABEL,
    DEFAULT_PARALLEL_WORKERS,
    DEFAULT_QUALITY_MAX_OFFSET_SECONDS,
    DEFAULT_SEGMENT_COUNT,
    DEFAULT_START_SECONDS,
    DEFAULT_VAD,
)
from ffsubsync_tpu_torch.version import get_version


def add_main_args_for_cli(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "reference",
        nargs="?",
        help=(
            "Reference (video, subtitles, or a numpy array with VAD speech) "
            "to which to synchronize input subtitles."
        ),
    )
    parser.add_argument(
        "-i",
        "--srtin",
        nargs="*",
        help=(
            "Input subtitles file (default=stdin). If omitted (and nothing is "
            "piped in), subtitles sharing the reference's name in its directory "
            "are auto-detected (e.g. `movie.srt`, `movie.en.srt` for `movie.mkv`) "
            "and each is synced to a `<name>.synced.srt` next to it; pass "
            "--overwrite-input to overwrite the detected file(s) in place."
        ),
    )
    parser.add_argument("-o", "--srtout", help="Output subtitles file (default=stdout).")
    parser.add_argument(
        "--merge-with-reference",
        "--merge",
        action="store_true",
        help="Merge reference subtitles with synced output subtitles.",
    )
    parser.add_argument(
        "--make-test-case",
        "--create-test-case",
        action="store_true",
        help="If specified, serialize reference speech to a numpy array, "
        "and create an archive with input/output subtitles "
        "and serialized speech.",
    )
    parser.add_argument(
        "--reference-stream",
        "--refstream",
        "--reference-track",
        "--reftrack",
        default=None,
        help=(
            "Which stream/track in the video file to use as reference, "
            "formatted according to ffmpeg conventions. For example, 0:s:0 "
            "uses the first subtitle track; 0:a:3 would use the third audio track. "
            "You can also drop the leading `0:`; i.e. use s:0 or a:3, respectively. "
            "Example: `ffs ref.mkv -i in.srt -o out.srt --reference-stream s:2`"
        ),
    )
    parser.add_argument(
        "--pgs-ref-stream",
        "--pgsstream",
        nargs="?",
        const="auto",
        default=None,
        help=(
            "Use a PGS (Presentation Graphic Stream) image-based subtitle track "
            "from the reference MKV as the sync reference instead of audio VAD. "
            "Optionally specify the stream (leading `0:` is optional, e.g. `s:0` "
            "or `3`). Omit the value to auto-detect the first hdmv_pgs_subtitle "
            "track."
        ),
    )


def add_cli_only_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-v",
        "--version",
        action="version",
        version="{package} {version}".format(
            package=__package__ or "ffsubsync_tpu_torch", version=get_version()
        ),
    )
    parser.add_argument(
        "--overwrite-input",
        action="store_true",
        help=(
            "If specified, will overwrite the input srt "
            "instead of writing the output to a new file."
        ),
    )
    parser.add_argument(
        "--encoding",
        default=DEFAULT_ENCODING,
        help="What encoding to use for reading input subtitles "
        "(default=%s)." % DEFAULT_ENCODING,
    )
    parser.add_argument(
        "--max-subtitle-seconds",
        type=float,
        default=DEFAULT_MAX_SUBTITLE_SECONDS,
        help="Maximum duration for a subtitle to appear on-screen "
        "(default=%.3f seconds)." % DEFAULT_MAX_SUBTITLE_SECONDS,
    )
    parser.add_argument(
        "--start-seconds",
        type=int,
        default=DEFAULT_START_SECONDS,
        help="Start time for processing "
        "(default=%d seconds)." % DEFAULT_START_SECONDS,
    )
    parser.add_argument(
        "--max-offset-seconds",
        type=float,
        default=DEFAULT_MAX_OFFSET_SECONDS,
        help="The max allowed offset seconds for any subtitle segment "
        "(default=%d seconds)." % DEFAULT_MAX_OFFSET_SECONDS,
    )
    parser.add_argument(
        "--max-duration-seconds",
        type=float,
        default=None,
        help="If specified, only process the first this-many seconds of the "
        "reference (measured from --start-seconds). Useful for speeding up "
        "long or remote references, since ffmpeg stops reading/downloading "
        "once this duration is reached.",
    )
    parser.add_argument(
        "--extract-audio-first",
        action="store_true",
        help="For remote URL references, first copy the audio track to a local "
        "temp file (no re-encode) and run speech detection on that, instead of "
        "streaming the full container over the network during detection. Can be "
        "more stable on flaky connections; ignored for local references.",
    )
    parser.add_argument(
        "--multi-segment-sync",
        action="store_true",
        help="Sample a few short segments spread across the reference and run "
        "speech detection only on those, instead of the whole reference. Speeds "
        "up long or remote references; the usual framerate and offset search is "
        "unchanged. Only applies to video / audio references.",
    )
    parser.add_argument(
        "--segment-count",
        type=int,
        default=DEFAULT_SEGMENT_COUNT,
        help="Number of segments to sample for --multi-segment-sync (default=8).",
    )
    parser.add_argument(
        "--skip-intro-outro",
        action="store_true",
        help="With --multi-segment-sync, skip the first 30s and last 60s of the "
        "reference when placing segments (intros/credits often lack dialogue).",
    )
    parser.add_argument(
        "--parallel-workers",
        type=int,
        default=DEFAULT_PARALLEL_WORKERS,
        help="How many segments to extract in parallel for --multi-segment-sync "
        "(default=4); useful for overlapping downloads of remote references.",
    )
    parser.add_argument(
        "--apply-offset-seconds",
        type=float,
        default=DEFAULT_APPLY_OFFSET_SECONDS,
        help="Apply a predefined offset in seconds to all subtitle segments "
        "(default=%d seconds)." % DEFAULT_APPLY_OFFSET_SECONDS,
    )
    parser.add_argument(
        "--skip-sync-on-low-quality",
        action="store_true",
        help="If the alignment looks untrustworthy (see the thresholds below), "
        "leave the subtitles unmodified instead of applying a probably-wrong "
        "sync. Useful for batch jobs where a bad sync is worse than none.",
    )
    parser.add_argument(
        "--min-score",
        type=float,
        default=DEFAULT_MIN_SCORE,
        help="With --skip-sync-on-low-quality, reject alignments scoring below "
        "this. The score's magnitude is not normalized, but its sign is "
        "meaningful, so the default of %.1f rejects only anti-correlated "
        "(clearly wrong) alignments." % DEFAULT_MIN_SCORE,
    )
    parser.add_argument(
        "--quality-max-offset-seconds",
        type=float,
        default=DEFAULT_QUALITY_MAX_OFFSET_SECONDS,
        help="With --skip-sync-on-low-quality, reject alignments whose offset "
        "exceeds this many seconds (default=%.1f)."
        % DEFAULT_QUALITY_MAX_OFFSET_SECONDS,
    )
    parser.add_argument(
        "--max-framerate-deviation",
        type=float,
        default=DEFAULT_MAX_FRAMERATE_DEVIATION,
        help="With --skip-sync-on-low-quality, reject alignments whose framerate "
        "scale deviates from 1.0 by more than this (default=%.2f)."
        % DEFAULT_MAX_FRAMERATE_DEVIATION,
    )
    parser.add_argument(
        "--frame-rate",
        type=int,
        default=DEFAULT_FRAME_RATE,
        help="Frame rate for audio extraction (default=%d)." % DEFAULT_FRAME_RATE,
    )
    parser.add_argument(
        "--skip-infer-framerate-ratio",
        action="store_true",
        help="If set, do not try to infer framerate ratio based on duration ratio.",
    )
    parser.add_argument(
        "--non-speech-label",
        type=float,
        default=DEFAULT_NON_SPEECH_LABEL,
        help="Label to use for frames detected as non-speech (default=%f)"
        % DEFAULT_NON_SPEECH_LABEL,
    )
    parser.add_argument(
        "--output-encoding",
        default="utf-8",
        help="What encoding to use for writing output subtitles "
        '(default=utf-8). Can indicate "same" to use same '
        "encoding as that of the input.",
    )
    parser.add_argument(
        "--reference-encoding",
        help="What encoding to use for reading / writing reference subtitles "
        "(if applicable, default=infer).",
    )
    parser.add_argument(
        "--vad",
        choices=[
            "subs_then_webrtc",
            "webrtc",
            "subs_then_auditok",
            "auditok",
            "subs_then_silero",
            "silero",
            "fused",
            "fused:weighted",
            "fused:intersection",
            "fused:union",
        ],
        default=None,
        help="Which voice activity detector to use for speech extraction "
        "(if using video / audio as a reference, default={}). All detectors "
        "run as TPU kernels; names select behaviorally-equivalent backends "
        "(webrtc → spectral GMM-class kernel, silero → neural VAD, auditok → "
        "energy tokenizer). On telephone-band (8 kHz) audio the webrtc-class "
        "kernel's accuracy bound does not apply (its SNR bands and motion "
        "statistics coarsen with the top octaves gone — see EVAL.md); "
        "8 kHz defaults route through the neural backends, which stay "
        "bound there.".format(DEFAULT_VAD),
    )
    parser.add_argument(
        "--no-fix-framerate",
        action="store_true",
        help="If specified, subsync will not attempt to correct a framerate "
        "mismatch between reference and subtitles.",
    )
    parser.add_argument(
        "--serialize-speech",
        action="store_true",
        help="If specified, serialize reference speech to a numpy array.",
    )
    parser.add_argument(
        "--extract-subs-from-stream",
        "--extract-subtitles-from-stream",
        default=None,
        help="If specified, do not attempt sync; instead, just extract subtitles"
        " from the specified stream using the reference.",
    )
    parser.add_argument(
        "--suppress-output-if-offset-less-than",
        type=float,
        default=None,
        help="If specified, do not produce output if offset below provided threshold.",
    )
    parser.add_argument(
        "--ffmpeg-path",
        "--ffmpegpath",
        default=None,
        help="Where to look for ffmpeg and ffprobe. Uses the system PATH by default.",
    )
    parser.add_argument(
        "--log-dir-path",
        default=None,
        help=(
            "If provided, will save log file ffsubsync.log to this path "
            "(must be an existing directory)."
        ),
    )
    parser.add_argument(
        "--gss",
        action="store_true",
        help="If specified, use golden-section search to try to find"
        "the optimal framerate ratio between video and subtitles.",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="If specified, refuse to parse srt files with formatting issues.",
    )
    parser.add_argument("--vlc-mode", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--gui-mode", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--skip-sync", action="store_true", help=argparse.SUPPRESS)
    # --- TPU-specific extensions (additive) ---
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="Capture a device profile of the sync into this directory "
        "(jax.profiler trace, viewable in TensorBoard/XProf or Perfetto). "
        "The reference has no profiler; this is TPU-native observability.",
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Synchronize subtitles with video.",
        # additive TPU surface only — the flag set above stays drop-in
        # compatible with the reference CLI
        epilog=(
            "TPU environment toggles: FFS_TPU_SP_VAD=1 shards one movie's "
            "VAD across all attached devices (sequence parallelism; needs "
            ">=2 devices); FFS_TPU_PIPELINE_SECONDS sets the async "
            "dispatch chunk length (0 = one monolithic launch); "
            "FFS_TPU_STREAMING_VAD=1 forces constant-memory streaming. "
            "See docs/index.md for the full list."
        ),
    )
    add_main_args_for_cli(parser)
    add_cli_only_args(parser)
    return parser
