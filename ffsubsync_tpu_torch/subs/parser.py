# -*- coding: utf-8 -*-
"""Subtitle file reading: bytes → decoded text → preprocessed document.

Parity surface (ffsubsync/subtitle_parser.py:34-175):
- input can be a path, stdin (None), a remote URL, or a file-like object;
- encoding inference when ``encoding == "infer"``;
- decode with ``errors="replace"``;
- preprocessing drops cues starting before ``start_seconds`` and clamps cue
  duration to ``max_subtitle_seconds``;
- ``caching=True`` makes repeated fits of the same filename no-ops (the
  candidate-ratio search re-reads the same input many times);
- ``strict=True`` refuses malformed srt blocks instead of skipping them.
"""
import logging
from typing import Any, List, Optional

from ffsubsync_tpu_torch.constants import (
    DEFAULT_ENCODING,
    DEFAULT_MAX_SUBTITLE_SECONDS,
    DEFAULT_START_SECONDS,
)
from ffsubsync_tpu_torch.subs import formats
from ffsubsync_tpu_torch.subs.model import Cue, SubtitleDocument, seconds_to_us
from ffsubsync_tpu_torch.utils.encodings import infer_encoding
from ffsubsync_tpu_torch.utils.file_io import open_file

logger = logging.getLogger(__name__)


def _preprocess_cues(
    cues: List[Cue],
    max_subtitle_seconds: Optional[float] = None,
    start_seconds: float = 0,
) -> List[Cue]:
    start_us = seconds_to_us(start_seconds)
    max_duration_us = 86_400_000_000  # one day, as in the reference
    if max_subtitle_seconds is not None:
        max_duration_us = seconds_to_us(max_subtitle_seconds)
    out: List[Cue] = []
    for cue in cues:
        if cue.start_us < start_us:
            continue
        end_us = min(cue.end_us, cue.start_us + max_duration_us)
        if end_us != cue.end_us:
            cue = cue.with_times(cue.start_us, end_us)
        out.append(cue)
    return out


class SubtitleParser:
    """Stateful parser with filename-keyed caching (reference: GenericSubtitleParser)."""

    def __init__(
        self,
        fmt: str = "srt",
        encoding: str = DEFAULT_ENCODING,
        caching: bool = False,
        max_subtitle_seconds: Optional[float] = None,
        start_seconds: float = 0,
        strict: bool = False,
    ) -> None:
        self.sub_format = fmt
        self.encoding = encoding
        self.caching = caching
        self.max_subtitle_seconds = max_subtitle_seconds
        self.start_seconds = start_seconds
        self.strict = strict
        self.fit_fname: Optional[str] = None
        self.detected_encoding_: Optional[str] = None
        self.subs_: Optional[SubtitleDocument] = None

    def fit(self, fname: Any) -> "SubtitleParser":
        if self.caching and self.fit_fname == (
            "<stdin>" if fname is None else fname
        ):
            return self
        with open_file(fname, "rb") as f:
            raw = f.read()
        encodings_to_try = (self.encoding,)
        if self.encoding == "infer":
            detected = infer_encoding(raw)
            if detected is None:
                raise ValueError(
                    "unable to detect encoding of input subtitles; "
                    "specify one explicitly with --encoding"
                )
            self.detected_encoding_ = detected
            encodings_to_try = (detected,)
            logger.info("detected encoding: %s", detected)
        exc: Optional[Exception] = None
        for encoding in encodings_to_try:
            try:
                decoded = raw.decode(encoding, errors="replace").strip()
                doc = formats.parse_document(
                    decoded, self.sub_format, encoding, strict=self.strict
                )
                doc.cues = _preprocess_cues(
                    doc.cues,
                    max_subtitle_seconds=self.max_subtitle_seconds,
                    start_seconds=self.start_seconds,
                )
                self.subs_ = doc
                self.fit_fname = "<stdin>" if fname is None else fname
                return self
            except Exception as e:  # try the next encoding, as the reference does
                exc = e
                continue
        assert exc is not None
        raise exc

    def transform(self, *_: Any) -> SubtitleDocument:
        assert self.subs_ is not None
        return self.subs_


def make_subtitle_parser(
    fmt: str,
    encoding: str = DEFAULT_ENCODING,
    caching: bool = False,
    max_subtitle_seconds: float = DEFAULT_MAX_SUBTITLE_SECONDS,
    start_seconds: float = DEFAULT_START_SECONDS,
    **kwargs: Any,
) -> SubtitleParser:
    return SubtitleParser(
        fmt=fmt,
        encoding=encoding,
        caching=caching,
        max_subtitle_seconds=max_subtitle_seconds,
        start_seconds=start_seconds,
        strict=kwargs.get("strict", False),
    )
