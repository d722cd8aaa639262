# -*- coding: utf-8 -*-
"""Candidate rasters of one subtitle file at many framerate ratios.

A sync fits one :class:`~ffsubsync_tpu_torch.speech.SubtitleSpeechSource`
per candidate ratio of the same parsed document: 7 for the grid (8 with an
inferred ratio), 33 more per ``--gss`` round. The pinned source scales the
document into new cues and runs the metadata heuristic on every cue again
at each ratio, although only the rounding of the times depends on the
ratio. :class:`CandidateSource` computes what does not once per parsed
document (:class:`CueArrays`: the cue times as arrays, the metadata mask)
and each ratio's :class:`~ffsubsync_tpu_torch.subs.raster.RasterSpec` by
array arithmetic, bit for bit the pinned ``rasterize_cues(scale_document(
doc, ratio).cues, ...)``. The scaled document is built only where it is
read: the chosen candidate's, for the output.

Counters (:func:`~ffsubsync_tpu_torch.utils.tracing.count`):
``raster.fits``, one per candidate fitted, and ``raster.cue_arrays``, one
per document whose arrays were built; ``1 - cue_arrays / fits`` is the
share of fits that reused a document's arrays.
"""
import weakref
from typing import Any, Optional

import numpy as np

from ffsubsync_tpu_torch.constants import SAMPLE_RATE
from ffsubsync_tpu_torch.speech import SubtitleSpeechSource
from ffsubsync_tpu_torch.subs.metadata import is_metadata
from ffsubsync_tpu_torch.subs.model import US_PER_SECOND, SubtitleDocument
from ffsubsync_tpu_torch.subs.raster import RasterSpec
from ffsubsync_tpu_torch.subs.transforms import scale_document
from ffsubsync_tpu_torch.utils import tracing


class CueArrays:
    """What a document's rasters share at every ratio: each cue's start and
    end in microseconds (int64) and whether it is dialogue (``keep``: not
    ``is_metadata``, the first and the last cue scrutinised)."""

    def __init__(self, doc: SubtitleDocument) -> None:
        cues = doc.cues
        n = len(cues)
        self.start_us = np.fromiter((c.start_us for c in cues), np.int64, n)
        self.end_us = np.fromiter((c.end_us for c in cues), np.int64, n)
        self.keep = np.fromiter(
            (not is_metadata(c.content, i == 0 or i + 1 == n) for i, c in enumerate(cues)),
            bool, n,
        )

    def spec(self, ratio: float, start_seconds: float) -> RasterSpec:
        """The raster at :data:`SAMPLE_RATE` of the document scaled by
        ``ratio``, in the float64 operations of ``scale_document`` and
        ``rasterize_cues``, in their order: each time scaled in seconds and
        rounded half-to-even to microseconds, each kept cue's start and
        duration rounded to samples, the slice resolved as numpy resolves
        ``arr[start:end]``."""

        def seconds(us: np.ndarray) -> np.ndarray:
            scaled_us = np.rint(us / US_PER_SECOND * ratio * US_PER_SECOND).astype(np.int64)
            return scaled_us / US_PER_SECOND

        end_s = seconds(self.end_us)
        max_time = max(0.0, float(end_s.max())) if len(end_s) else 0.0
        n_samples = int(max_time * SAMPLE_RATE) + 2
        weight = min(1.0 / ratio, 1.0)
        start_s, end_s = seconds(self.start_us[self.keep]), end_s[self.keep]
        start = np.rint((start_s - start_seconds) * SAMPLE_RATE).astype(np.int64)
        end = start + np.rint((end_s - start_s) * SAMPLE_RATE).astype(np.int64)
        s = np.clip(np.where(start >= 0, start, n_samples + start), 0, n_samples)
        e = np.clip(np.where(end >= 0, end, n_samples + end), 0, n_samples)
        return RasterSpec(
            n_samples=n_samples,
            starts=s.astype(np.int32),
            ends=np.maximum(s, e).astype(np.int32),
            weight=weight,
            max_time=max_time - start_seconds,
            sample_rate=SAMPLE_RATE,
        )


# each parsed document's arrays, for as long as the document lives (a weak
# key: the entry goes with the document): a caching parser hands every
# ratio of a job the same document
_arrays: "weakref.WeakKeyDictionary[SubtitleDocument, CueArrays]" = weakref.WeakKeyDictionary()


def cue_arrays(doc: SubtitleDocument) -> CueArrays:
    """``doc``'s :class:`CueArrays`, built on the first call for it."""
    arrays = _arrays.get(doc)
    if arrays is None:
        tracing.count("raster.cue_arrays")
        arrays = _arrays[doc] = CueArrays(doc)
    return arrays


class CandidateSource(SubtitleSpeechSource):
    """A :class:`SubtitleSpeechSource` for one of many candidate ratios of
    a subtitle file: the same surface (``spec_``, ``scale_factor``,
    ``parsed_doc_``, ``scaled_doc_``, ``num_frames``, ``signal_or_spec``,
    ``transform``), its spec from the document's :class:`CueArrays`, its
    ``scaled_doc_`` built by ``scale_document`` when first read."""

    _scaled_doc: Optional[SubtitleDocument] = None

    @classmethod
    def of(cls, source: SubtitleSpeechSource) -> "CandidateSource":
        """An unfitted candidate on ``source``'s parser, at its ratio."""
        parser = source.parser
        return cls(
            encoding=parser.encoding,
            max_subtitle_seconds=parser.max_subtitle_seconds,
            start_seconds=source.start_seconds,
            scale_factor=source.scale_factor,
            parser=parser,
        )

    @tracing.spanned("raster")
    def fit(self, fname: Any) -> "CandidateSource":
        tracing.count("raster.fits")
        self.parser.fit(fname)
        self.parsed_doc_ = self.parser.subs_
        self._scaled_doc = None
        self.spec_ = cue_arrays(self.parsed_doc_).spec(self.scale_factor, self.start_seconds)
        return self

    @property
    def scaled_doc_(self) -> Optional[SubtitleDocument]:
        if self._scaled_doc is None and self.parsed_doc_ is not None:
            self._scaled_doc = scale_document(self.parsed_doc_, self.scale_factor)
        return self._scaled_doc

    @scaled_doc_.setter
    def scaled_doc_(self, doc: Optional[SubtitleDocument]) -> None:
        self._scaled_doc = doc
