# -*- coding: utf-8 -*-
"""Cue rasterization: subtitle documents → 100 Hz speech-signal geometry.

The reference materializes a float array per candidate pipe on the host
(ffsubsync/speech_transformers.py:946-984). Here the host computes only the
*geometry* — sample-index intervals, weight, signal length — as a
:class:`RasterSpec`; the heavy work (scatter-rasterize, ±1 mapping, FFT
correlation) happens on the TPU in one batched launch (see
:mod:`ffsubsync_tpu_torch.ops.align`). ``materialize`` reproduces the reference's
host array bit-for-bit for serialization and tests.

Index arithmetic parity notes (speech_transformers.py:957-980):
- signal length = ``int(max_end_seconds * rate) + 2`` where ``max_end`` spans
  *all* cues (metadata cues included), *before* subtracting start_seconds;
- per cue: ``start = int(round((start_s - start_seconds) * rate))``,
  ``end = start + int(round(duration_s * rate))`` (duration rounded
  separately, Python banker's rounding);
- the written value is ``min(1/framerate_ratio, 1.0)`` — candidates that
  stretched the subtitles are down-weighted so an unstretched candidate wins
  ties;
- metadata cues (with first/last-cue scrutiny) are skipped;
- slice semantics are numpy's (negative/overshooting indices clip; an empty
  slice writes nothing).
"""
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ffsubsync_tpu_torch.subs.metadata import is_metadata
from ffsubsync_tpu_torch.subs.model import Cue


def _resolve_slice(start: int, end: int, n: int) -> Tuple[int, int]:
    """Resolve ``arr[start:end] = w`` target interval under numpy semantics."""
    s = start if start >= 0 else n + start
    s = min(max(s, 0), n)
    e = end if end >= 0 else n + end
    e = min(max(e, 0), n)
    return s, max(s, e)


@dataclass
class RasterSpec:
    """Geometry of one rasterized speech signal.

    ``starts``/``ends`` are resolved, in-range, half-open sample intervals;
    the signal equals ``weight`` on their union and 0 elsewhere.
    """

    n_samples: int
    starts: np.ndarray  # int32[C]
    ends: np.ndarray  # int32[C]
    weight: float
    max_time: float  # max cue end (seconds) minus start_seconds
    sample_rate: int

    @property
    def start_frame(self) -> Optional[int]:
        """First sample with value > 0.5, or None (parity: fit_boundaries)."""
        if self.weight <= 0.5:
            return None
        nonempty = self.starts[self.ends > self.starts]
        if len(nonempty) == 0:
            return None
        return int(nonempty.min())

    @property
    def end_frame(self) -> Optional[int]:
        """Last sample with value > 0.5, or None."""
        if self.weight <= 0.5:
            return None
        mask = self.ends > self.starts
        if not mask.any():
            return None
        return int(self.ends[mask].max()) - 1

    @property
    def num_frames(self) -> Optional[int]:
        """Speech span in samples (reference: ComputeSpeechFrameBoundariesMixin)."""
        if self.start_frame is None or self.end_frame is None:
            return None
        return self.end_frame - self.start_frame

    def materialize(self) -> np.ndarray:
        """Produce the float64 signal array exactly as the reference builds it."""
        samples = np.zeros(self.n_samples, dtype=float)
        for s, e in zip(self.starts, self.ends):
            samples[s:e] = self.weight
        return samples


def rasterize_cues(
    cues: Sequence[Cue],
    sample_rate: int,
    start_seconds: float = 0,
    framerate_ratio: float = 1.0,
) -> RasterSpec:
    """Compute the raster geometry for *cues* (already scaled, if applicable)."""
    max_time = 0.0
    for cue in cues:
        max_time = max(max_time, cue.end_seconds)
    n_samples = int(max_time * sample_rate) + 2
    weight = min(1.0 / framerate_ratio, 1.0)
    starts: List[int] = []
    ends: List[int] = []
    n_cues = len(cues)
    for i, cue in enumerate(cues):
        if is_metadata(cue.content, i == 0 or i + 1 == n_cues):
            continue
        start = int(round((cue.start_seconds - start_seconds) * sample_rate))
        duration = cue.end_seconds - cue.start_seconds
        end = start + int(round(duration * sample_rate))
        s, e = _resolve_slice(start, end, n_samples)
        starts.append(s)
        ends.append(e)
    return RasterSpec(
        n_samples=n_samples,
        starts=np.asarray(starts, dtype=np.int32),
        ends=np.asarray(ends, dtype=np.int32),
        weight=weight,
        max_time=max_time - start_seconds,
        sample_rate=sample_rate,
    )


def rasterize_intervals(
    intervals: Sequence[Tuple[float, float]],
    sample_rate: int,
    start_seconds: float = 0,
) -> RasterSpec:
    """Raster geometry for raw (start_s, end_s) intervals (PGS path).

    Parity with PGSSpeechTransformer (speech_transformers.py:1186-1197):
    length from the max end time, per-interval rounding, clamping into range.
    """
    if not intervals:
        return RasterSpec(
            n_samples=0,
            starts=np.zeros(0, np.int32),
            ends=np.zeros(0, np.int32),
            weight=1.0,
            max_time=0.0,
            sample_rate=sample_rate,
        )
    max_time = max(end for _, end in intervals)
    n_samples = int(max_time * sample_rate) + 2
    starts: List[int] = []
    ends: List[int] = []
    for start, end in intervals:
        s = int(round((start - start_seconds) * sample_rate))
        e = int(round((end - start_seconds) * sample_rate))
        s = max(s, 0)
        e = min(e, n_samples)
        if s < e:
            starts.append(s)
            ends.append(e)
    return RasterSpec(
        n_samples=n_samples,
        starts=np.asarray(starts, dtype=np.int32),
        ends=np.asarray(ends, dtype=np.int32),
        weight=1.0,
        max_time=max_time,
        sample_rate=sample_rate,
    )


def boundaries_of_signal(signal: np.ndarray) -> Tuple[Optional[int], Optional[int]]:
    """(start_frame, end_frame) of a materialized signal: positions > 0.5."""
    nz = np.nonzero(signal > 0.5)[0]
    if len(nz) == 0:
        return None, None
    return int(nz.min()), int(nz.max())
