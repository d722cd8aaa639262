# -*- coding: utf-8 -*-
"""Embedded-subtitle extraction from video containers.

Behavior parity with the reference (ffsubsync/speech_transformers.py:353-523):

- enumerate text-based subtitle streams via ffprobe CSV, skipping bitmap
  codecs that cannot be muxed to SRT (they would abort the whole extraction);
- extract *all* streams in a single ffmpeg pass to temp files (~5× faster than
  per-stream invocations), falling back to per-stream stdout extraction when
  the single pass fails or ffprobe is unavailable (first-5-streams probe);
- rasterize each extracted track and keep the longest one (by max cue time).
"""
import io
import logging
import os
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from ffsubsync_tpu_torch.media.ffmpeg import ffmpeg_bin_path, subprocess_args
from ffsubsync_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

# bitmap (image-based) subtitle codecs cannot be muxed to SRT; mapping one
# into an SRT extraction aborts the whole ffmpeg invocation
BITMAP_SUBTITLE_CODECS = frozenset(
    {
        "hdmv_pgs_subtitle",
        "dvd_subtitle",
        "dvb_subtitle",
        "dvb_teletext",
        "xsub",
    }
)


def probe_embedded_subtitle_streams(
    fname: str,
    gui_mode: bool = False,
    ffmpeg_path: Optional[str] = None,
) -> Optional[List[str]]:
    """Enumerate text-based subtitle streams as ffmpeg ``-map`` specifiers.

    Returns ``None`` when ffprobe is unavailable or fails, signaling the
    caller to fall back to per-stream extraction.
    """
    ffprobe_args = [
        ffmpeg_bin_path("ffprobe", gui_mode, ffmpeg_resources_path=ffmpeg_path),
        "-loglevel",
        "fatal",
        "-select_streams",
        "s",
        "-show_entries",
        "stream=index,codec_name",
        "-of",
        "csv=p=0",
        fname,
    ]
    try:
        with tracing.span("spawn"):
            process = subprocess.Popen(ffprobe_args, **subprocess_args(include_stdout=True))
        output = process.communicate()[0]
    except OSError as e:
        logger.warning("ffprobe unavailable while enumerating subtitles: %s", e)
        return None
    if process.returncode != 0:
        return None
    streams: List[str] = []
    for line in output.decode("utf-8", errors="replace").splitlines():
        parts = line.strip().split(",")
        if not parts or not parts[0].isdigit():
            continue
        index = parts[0]
        codec_name = parts[1].strip().lower() if len(parts) > 1 else ""
        if codec_name in BITMAP_SUBTITLE_CODECS:
            continue
        streams.append("0:{}".format(index))
    return streams or None


def extract_subs_single_pass(
    fname: str,
    streams: List[str],
    gui_mode: bool = False,
    ffmpeg_path: Optional[str] = None,
) -> Optional[List[io.BytesIO]]:
    """Extract several subtitle streams in one ffmpeg invocation.

    ffmpeg can only send a single output to stdout, so each stream goes to a
    temp file (system temp dir — never next to the source media), is read back
    into memory, and deleted with the temp dir. Returns ``None`` if the whole
    invocation failed (caller falls back to per-stream extraction).
    """
    with tempfile.TemporaryDirectory(prefix="ffsubsync_subs_") as tmpdir:
        ffmpeg_args = [
            ffmpeg_bin_path("ffmpeg", gui_mode, ffmpeg_resources_path=ffmpeg_path),
            "-loglevel",
            "fatal",
            "-nostdin",
            "-i",
            fname,
        ]
        out_paths: List[str] = []
        for i, stream in enumerate(streams):
            out_path = os.path.join(tmpdir, "embedded.{}.srt".format(i))
            out_paths.append(out_path)
            ffmpeg_args.extend(["-map", "{}".format(stream), "-f", "srt", out_path])
        with tracing.span("spawn"):
            process = subprocess.Popen(ffmpeg_args, **subprocess_args(include_stdout=True))
        process.communicate()
        if process.returncode != 0:
            return None
        buffers: List[io.BytesIO] = []
        for out_path in out_paths:
            if not os.path.exists(out_path) or os.path.getsize(out_path) == 0:
                continue
            with open(out_path, "rb") as f:
                buffers.append(io.BytesIO(f.read()))
        return buffers


def extract_subs_per_stream(
    fname: str,
    streams: List[str],
    gui_mode: bool = False,
    ffmpeg_path: Optional[str] = None,
) -> List[io.BytesIO]:
    """Extract subtitle streams one ffmpeg invocation at a time (to stdout).

    Fallback path; stops at the first stream ffmpeg cannot extract.
    """
    buffers: List[io.BytesIO] = []
    for stream in streams:
        ffmpeg_args = [
            ffmpeg_bin_path("ffmpeg", gui_mode, ffmpeg_resources_path=ffmpeg_path),
            "-loglevel",
            "fatal",
            "-nostdin",
            "-i",
            fname,
            "-map",
            "{}".format(stream),
            "-f",
            "srt",
            "-",
        ]
        with tracing.span("spawn"):
            process = subprocess.Popen(ffmpeg_args, **subprocess_args(include_stdout=True))
        output = process.communicate()[0]
        if process.returncode != 0:
            break
        buffers.append(io.BytesIO(output))
    return buffers


def fit_embedded_subs(
    fname: str,
    start_seconds: float,
    ref_stream: Optional[str],
    gui_mode: bool = False,
    ffmpeg_path: Optional[str] = None,
):
    """Try to build the reference speech signal from embedded subtitles.

    Returns the :class:`~ffsubsync_tpu_torch.subs.raster.RasterSpec` of the longest
    embedded track. Raises ``ValueError`` when no usable track exists.
    """
    from ffsubsync_tpu_torch.speech import SubtitleSpeechSource

    if ref_stream is not None:
        subtitle_buffers = extract_subs_per_stream(
            fname, [ref_stream], gui_mode, ffmpeg_path
        )
    else:
        streams = probe_embedded_subtitle_streams(fname, gui_mode, ffmpeg_path)
        if streams:
            subtitle_buffers = extract_subs_single_pass(
                fname, streams, gui_mode, ffmpeg_path
            )
            if subtitle_buffers is None:
                # single pass failed; degrade to per-stream over the same
                # (known-present) streams
                subtitle_buffers = extract_subs_per_stream(
                    fname, streams, gui_mode, ffmpeg_path
                )
        else:
            # ffprobe unavailable/failed: probe the first 5 streams
            # individually (covers nearly all movies)
            subtitle_buffers = extract_subs_per_stream(
                fname, ["0:s:{}".format(i) for i in range(5)], gui_mode, ffmpeg_path
            )
    embedded_specs = []
    embedded_times = []
    for buffer in subtitle_buffers or []:
        source = SubtitleSpeechSource(start_seconds=start_seconds)
        source.fit(buffer)
        embedded_specs.append(source.spec_)
        embedded_times.append(source.max_time_)
    if len(embedded_specs) == 0:
        if ref_stream is None:
            raise ValueError("Video file appears to lack subtitle stream")
        raise ValueError("Stream {} not found".format(ref_stream))
    # use the longest set of embedded subs
    return embedded_specs[int(np.argmax(embedded_times))]
