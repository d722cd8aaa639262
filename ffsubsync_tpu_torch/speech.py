# -*- coding: utf-8 -*-
"""Speech-signal sources: everything that can act as a sync reference or input.

The reference expresses these as sklearn-style transformer pipelines
(ffsubsync/speech_transformers.py); here each source is a small class with a
``fit(path) -> self`` / ``transform() -> np.ndarray`` surface (kept for
library-parity) plus the device-oriented accessors the TPU sync core uses:

- ``signal_or_spec()`` returns either a :class:`RasterSpec` (cue geometry the
  device rasterizes itself) or a materialized numpy signal (audio VAD,
  deserialized arrays) — whichever avoids host work;
- ``num_frames`` feeds the duration-based framerate-ratio inference
  (ffsubsync/ffsubsync.py:205-223); sources that cannot support it return
  ``None`` (video VAD has no boundaries; PGS disables it deliberately,
  speech_transformers.py:1127-1130).
"""
import logging
from typing import Any, Optional, Union

import numpy as np

from ffsubsync_tpu_torch.constants import (
    DEFAULT_ENCODING,
    DEFAULT_MAX_SUBTITLE_SECONDS,
    DEFAULT_SCALE_FACTOR,
    DEFAULT_START_SECONDS,
    SAMPLE_RATE,
)
from ffsubsync_tpu_torch.subs.model import SubtitleDocument
from ffsubsync_tpu_torch.subs.parser import SubtitleParser, make_subtitle_parser
from ffsubsync_tpu_torch.subs.raster import RasterSpec, rasterize_cues
from ffsubsync_tpu_torch.subs.transforms import scale_document

logger = logging.getLogger(__name__)

SignalOrSpec = Union[RasterSpec, np.ndarray]


class SubtitleSpeechSource:
    """Subtitle file → scaled document → 100 Hz raster geometry.

    Equivalent of the reference's parse→scale→speech_extract pipeline
    (speech_transformers.py:79-93): parsing (with caching), scaling by the
    candidate framerate ratio, and rasterization with the ``min(1/ratio, 1)``
    down-weighting of stretched candidates.
    """

    # as an alignment *reference* this source involves no audio pipeline, so
    # scoring runs host-side (ops/align._resolve_host_align)
    prefer_host_align = True

    def __init__(
        self,
        fmt: str = "srt",
        encoding: str = DEFAULT_ENCODING,
        caching: bool = False,
        max_subtitle_seconds: float = DEFAULT_MAX_SUBTITLE_SECONDS,
        start_seconds: float = DEFAULT_START_SECONDS,
        scale_factor: float = DEFAULT_SCALE_FACTOR,
        parser: Optional[SubtitleParser] = None,
        **kwargs: Any,
    ) -> None:
        if parser is None:
            parser = make_subtitle_parser(
                fmt,
                encoding=encoding,
                caching=caching,
                max_subtitle_seconds=max_subtitle_seconds,
                start_seconds=start_seconds,
                **kwargs,
            )
        assert parser.encoding == encoding
        assert parser.max_subtitle_seconds == max_subtitle_seconds
        assert parser.start_seconds == start_seconds
        self.parser = parser
        self.scale_factor = scale_factor
        self.start_seconds = start_seconds
        self.parsed_doc_: Optional[SubtitleDocument] = None
        self.scaled_doc_: Optional[SubtitleDocument] = None
        self.spec_: Optional[RasterSpec] = None

    def fit(self, fname: Any) -> "SubtitleSpeechSource":
        self.parser.fit(fname)
        self.parsed_doc_ = self.parser.subs_
        self.scaled_doc_ = scale_document(self.parsed_doc_, self.scale_factor)
        self.spec_ = rasterize_cues(
            self.scaled_doc_.cues,
            sample_rate=SAMPLE_RATE,
            start_seconds=self.start_seconds,
            framerate_ratio=self.scale_factor,
        )
        return self

    def transform(self, *_: Any) -> np.ndarray:
        assert self.spec_ is not None
        return self.spec_.materialize()

    def signal_or_spec(self) -> RasterSpec:
        assert self.spec_ is not None
        return self.spec_

    @property
    def num_frames(self) -> Optional[int]:
        assert self.spec_ is not None
        return self.spec_.num_frames

    @property
    def max_time_(self) -> Optional[float]:
        assert self.spec_ is not None
        return self.spec_.max_time


class DeserializeSpeechSource:
    """Load a previously serialized speech signal (.npy / .npz with "speech").

    Values below 1.0 are remapped to the *current* non-speech label, matching
    DeserializeSpeechTransformer (speech_transformers.py:987-1009).
    """

    num_frames: Optional[int] = None
    # a deserialized signal needs no device session; align on the host
    prefer_host_align = True

    def __init__(self, non_speech_label: float) -> None:
        self._non_speech_label = non_speech_label
        self.deserialized_speech_results_: Optional[np.ndarray] = None

    def fit(self, fname: str, *_: Any) -> "DeserializeSpeechSource":
        speech = np.load(fname)
        if hasattr(speech, "files"):
            if "speech" in speech.files:
                speech = speech["speech"]
            else:
                raise ValueError(
                    'could not find "speech" array in '
                    "serialized file; only contains: %s" % speech.files
                )
        speech[speech < 1.0] = self._non_speech_label
        self.deserialized_speech_results_ = speech
        return self

    def transform(self, *_: Any) -> np.ndarray:
        assert self.deserialized_speech_results_ is not None
        return self.deserialized_speech_results_

    def signal_or_spec(self) -> np.ndarray:
        assert self.deserialized_speech_results_ is not None
        return self.deserialized_speech_results_


def make_subtitle_speech_source(
    scale_factor: Optional[float],
    fmt: str = "srt",
    **kwargs: Any,
):
    """Source for one candidate ratio, or a factory when ``scale_factor=None``
    (the gss path passes the ratio per evaluation; parity:
    speech_transformers.py:95-98)."""
    def maker(ratio: float) -> SubtitleSpeechSource:
        return SubtitleSpeechSource(fmt=fmt, scale_factor=ratio, **kwargs)

    if scale_factor is None:
        return maker
    return maker(scale_factor)
