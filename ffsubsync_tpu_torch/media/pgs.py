# -*- coding: utf-8 -*-
"""PGS (bitmap subtitle) references: container timings → speech signal.

PGS subtitles are image-based and cannot be converted to text, but MKV stores
per-packet PTS and duration for subtitle streams, so when-captions-are-on-screen
can be recovered without decoding any bitmaps. Parity with the reference
(ffsubsync/speech_transformers.py:1012-1208): auto-detection of the first
``hdmv_pgs_subtitle`` track, per-packet ``pts_time/duration_time/size`` via
ffprobe, skipping tiny (≤50 byte) clear events and ``N/A`` durations, and a
``num_frames = None`` override that disables duration-based framerate
inference (PGS is already in the container timebase).
"""
import logging
from datetime import timedelta
from typing import Any, List, Optional, Tuple

import numpy as np

from ffsubsync_tpu_torch.media.ffmpeg import ffprobe_json
from ffsubsync_tpu_torch.subs.raster import RasterSpec, rasterize_intervals

logger = logging.getLogger(__name__)


def find_pgs_stream(
    fname: str,
    ffmpeg_path: Optional[str] = None,
    gui_mode: bool = False,
) -> Optional[str]:
    """ffmpeg stream specifier ("0:s:N") of the first PGS track, or None."""
    try:
        probe = ffprobe_json(fname, gui_mode, ffmpeg_resources_path=ffmpeg_path)
    except Exception as e:
        logger.warning("ffprobe failed while searching for PGS streams: %s", e)
        return None
    sub_index = 0
    for stream in probe.get("streams", []):
        if stream.get("codec_type") == "subtitle":
            if stream.get("codec_name") == "hdmv_pgs_subtitle":
                specifier = "0:s:{}".format(sub_index)
                logger.info(
                    "auto-detected PGS stream: %s (ffmpeg stream index %s)",
                    specifier,
                    stream.get("index"),
                )
                return specifier
            sub_index += 1
    return None


def get_pgs_timings(
    fname: str,
    stream: str,
    ffmpeg_path: Optional[str] = None,
    gui_mode: bool = False,
) -> Optional[List[Tuple[float, float]]]:
    """(start, end) second pairs for each PGS show event, from ffprobe packets.

    Show events are large packets with a numeric ``duration_time``; clear
    events are tiny (~30-byte) packets with ``duration_time=N/A``. Returns
    ``None`` when ffprobe fails or yields no usable durations.
    """
    # ffprobe -select_streams does not accept the "0:" input-index prefix
    probe_stream = stream[2:] if stream.startswith("0:") else stream
    try:
        probe_data = ffprobe_json(
            fname,
            gui_mode,
            ffmpeg_resources_path=ffmpeg_path,
            extra_args=[
                "-show_packets",
                "-select_streams",
                probe_stream,
                "-show_entries",
                "packet=pts_time,duration_time,size",
            ],
        )
    except Exception:
        return None
    results: List[Tuple[float, float]] = []
    for packet in probe_data.get("packets", []):
        pts_time_str = packet.get("pts_time")
        duration_time_str = packet.get("duration_time")
        size_str = packet.get("size")
        if pts_time_str is None or duration_time_str is None or size_str is None:
            continue
        if duration_time_str == "N/A":
            continue
        try:
            pts_time = float(pts_time_str)
            duration_time = float(duration_time_str)
            size = int(size_str)
        except ValueError:
            continue
        if size > 50:  # skip clear events (~30 bytes)
            results.append((pts_time, pts_time + duration_time))
    if not results:
        return None
    return results


class PGSSpeechSource:
    """Use PGS subtitle timings as the sync reference."""

    # PGS is already in the MKV timebase, so its duration cannot be compared
    # against the SRT to infer a framerate ratio
    num_frames: None = None
    # packet-timing extraction runs no audio pipeline; align on the host
    prefer_host_align = True

    def __init__(
        self,
        sample_rate: int,
        start_seconds: int = 0,
        ffmpeg_path: Optional[str] = None,
        ref_stream: Optional[str] = None,
        gui_mode: bool = False,
    ) -> None:
        self.sample_rate = sample_rate
        self.start_seconds = start_seconds
        self.ffmpeg_path = ffmpeg_path
        self.ref_stream = ref_stream
        self.gui_mode = gui_mode
        self.spec_: Optional[RasterSpec] = None

    def fit(self, fname: str, *_: Any) -> "PGSSpeechSource":
        if self.ref_stream is None:
            stream = find_pgs_stream(fname, self.ffmpeg_path, self.gui_mode)
            if stream is None:
                raise ValueError(
                    "No hdmv_pgs_subtitle stream found in {}. "
                    "Specify one explicitly with --pgs-ref-stream.".format(fname)
                )
        else:
            stream = self.ref_stream
            if not stream.startswith("0:"):
                stream = "0:" + stream
        logger.info("reading PGS timings for stream %s from %s...", stream, fname)
        timings = get_pgs_timings(fname, stream, self.ffmpeg_path, self.gui_mode)
        if timings is None:
            raise ValueError(
                "Failed to get PGS timings via ffprobe for stream {} from {}. "
                "Make sure the stream exists and is an hdmv_pgs_subtitle track "
                "(check with: ffprobe -show_streams {}).".format(stream, fname, fname)
            )
        if not timings:
            raise ValueError(
                "No subtitle timings found in PGS stream {}.".format(stream)
            )
        logger.info("found %d PGS subtitle segments", len(timings))
        for i, (s, e) in enumerate(timings[:8]):
            logger.debug(
                "  PGS[%d]: %s --> %s (%.3fs)",
                i,
                str(timedelta(seconds=s)),
                str(timedelta(seconds=e)),
                e - s,
            )
        self.spec_ = rasterize_intervals(
            timings, sample_rate=self.sample_rate, start_seconds=self.start_seconds
        )
        logger.info(
            "total PGS subtitle frames: %d",
            int(
                np.sum(
                    (self.spec_.ends - self.spec_.starts).astype(np.int64)
                )
            ),
        )
        return self

    def transform(self, *_: Any) -> np.ndarray:
        assert self.spec_ is not None
        return self.spec_.materialize()

    def signal_or_spec(self) -> RasterSpec:
        assert self.spec_ is not None
        return self.spec_
