# -*- coding: utf-8 -*-
"""Multi-segment sync: sparse sampled-segment speech extraction.

Counterpart of ``ffsubsync_tpu/media/segments.py`` (which imports jax
through its ``media.audio``). ``segment_count`` evenly spaced windows of at
most ``segment_duration`` seconds are sampled across the reference (with
optional 30 s / 60 s intro/outro margins), VAD runs only on those, and the
results land at their true positions in a full-length zero array, so the
framerate and offset search downstream is unchanged. Segments are decoded
by a thread pool; every segment's detector runs on the one ``device`` the
pool shares. A failed segment is logged and skipped.
"""
import logging
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ffsubsync_tpu_torch.constants import is_remote_url
from ffsubsync_tpu_torch.media.ffmpeg import probe_duration
from ffsubsync_tpu_torch.media.wav import WavReader, is_wav_file
from ffsubsync_tpu_torch.media.audio import VideoSpeechSource
from ffsubsync_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


class MultiSegmentVideoSpeechSource:
    """Sparse segment-sampled speech signal over the full reference timeline."""

    # margins skipped when skip_intro_outro is set (intros/credits often
    # lack dialogue)
    START_MARGIN_SECONDS: int = 30
    END_MARGIN_SECONDS: int = 60

    def __init__(
        self,
        vad: str,
        sample_rate: int,
        frame_rate: int,
        non_speech_label: float,
        device: torch.device,
        segment_count: int = 8,
        segment_duration: int = 60,
        skip_intro_outro: bool = False,
        parallel_workers: int = 4,
        ffmpeg_path: Optional[str] = None,
        ref_stream: Optional[str] = None,
        vlc_mode: bool = False,
        gui_mode: bool = False,
    ) -> None:
        # sampling is audio-only, so drop any "subs_then_" prefix
        # (embedded-subtitle extraction ignores the per-segment time window)
        self.vad = vad.split("subs_then_")[-1]
        self.sample_rate = sample_rate
        self.frame_rate = frame_rate
        self._non_speech_label = non_speech_label
        self.device = device
        self.segment_count = segment_count
        self.segment_duration = segment_duration
        self.skip_intro_outro = skip_intro_outro
        self.parallel_workers = parallel_workers
        self.ffmpeg_path = ffmpeg_path
        self.ref_stream = ref_stream
        self.vlc_mode = vlc_mode
        self.gui_mode = gui_mode
        self.video_speech_results_: Optional[np.ndarray] = None

    def _segment_starts(self, total_duration: float) -> List[int]:
        """Evenly spaced segment start times (seconds) across the reference."""
        duration = self.segment_duration
        if total_duration <= duration:
            return [0]
        start_margin = self.START_MARGIN_SECONDS if self.skip_intro_outro else 0
        end_margin = self.END_MARGIN_SECONDS if self.skip_intro_outro else 0
        lo = float(start_margin)
        hi = total_duration - end_margin
        if hi - lo < duration:  # margins too large for this reference
            lo, hi = 0.0, total_duration
        usable = hi - lo - duration
        n = max(1, self.segment_count)
        if usable <= 0 or n == 1:
            return [int(max(0.0, min(lo, total_duration - duration)))]
        step = usable / (n - 1)
        starts = [int(round(lo + i * step)) for i in range(n)]
        starts = [max(0, min(s, int(total_duration) - duration)) for s in starts]
        return sorted(set(starts))

    def _extract_segment_speech(self, fname: str, start: int) -> Tuple[int, np.ndarray]:
        """Run VAD over a single window, returning (start_seconds, speech array)."""
        segment = VideoSpeechSource(
            vad=self.vad,
            sample_rate=self.sample_rate,
            frame_rate=self.frame_rate,
            non_speech_label=self._non_speech_label,
            device=self.device,
            start_seconds=start,
            ffmpeg_path=self.ffmpeg_path,
            ref_stream=self.ref_stream,
            vlc_mode=self.vlc_mode,
            gui_mode=self.gui_mode,
            max_duration_seconds=self.segment_duration,
        )
        segment.fit(fname)
        return start, segment.transform()

    def _probe_total_duration(self, fname: str) -> float:
        if not is_remote_url(fname) and is_wav_file(fname):
            return WavReader(fname).duration_seconds
        return probe_duration(fname, self.gui_mode, ffmpeg_resources_path=self.ffmpeg_path)

    def fit(self, fname: str, *_: Any) -> "MultiSegmentVideoSpeechSource":
        try:
            total_duration = float(self._probe_total_duration(fname))
        except Exception as e:
            raise ValueError(
                "multi-segment sync needs the reference duration, but probing "
                "'%s' failed: %s" % (fname, e)
            )
        starts = self._segment_starts(total_duration)
        logger.info(
            "multi-segment sync: sampling %d segment(s) of up to %ds at %s",
            len(starts),
            self.segment_duration,
            [int(s) for s in starts],
        )
        sparse = np.zeros(int(total_duration * self.sample_rate) + 2, dtype=float)
        workers = max(1, min(self.parallel_workers, len(starts)))
        with ThreadPoolExecutor(max_workers=workers) as executor:
            future_to_start = {
                executor.submit(tracing.bind(self._extract_segment_speech), fname, start): start
                for start in starts
            }
            for future in as_completed(future_to_start):
                start = future_to_start[future]
                try:
                    start, seg_speech = future.result()
                except Exception as e:
                    # a single flaky segment shouldn't sink the whole sync; the
                    # remaining segments still localize the offset
                    logger.warning("failed to extract segment at %ds: %s", start, e)
                    continue
                begin = int(start * self.sample_rate)
                end = min(begin + len(seg_speech), len(sparse))
                if end > begin:
                    sparse[begin:end] = seg_speech[: end - begin]
        if not np.any(sparse > 0):
            raise ValueError(
                "Unable to detect speech in any sampled segment. "
                "Perhaps try specifying a different stream / track, "
                "or a different vad."
            )
        self.video_speech_results_ = sparse
        logger.info("total of speech segments: %s", np.sum(self.video_speech_results_))
        return self

    def transform(self, *_: Any) -> np.ndarray:
        assert self.video_speech_results_ is not None
        return self.video_speech_results_

    def signal_or_spec(self) -> np.ndarray:
        assert self.video_speech_results_ is not None
        return self.video_speech_results_
