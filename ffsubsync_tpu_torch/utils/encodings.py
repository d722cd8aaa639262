# -*- coding: utf-8 -*-
"""Byte-stream encoding inference.

Parity with the reference's detector chain (ffsubsync/subtitle_parser.py:6-17,
97-110): try cchardet, then charset_normalizer, then chardet — whichever is
importable — and return the first non-None encoding name. All three are
host-side text tooling, deliberately kept out of the device compute path.
"""
import logging
from typing import Optional

logger = logging.getLogger(__name__)

try:
    import cchardet  # type: ignore
except Exception:  # pragma: no cover - availability varies by platform
    cchardet = None
try:
    import charset_normalizer  # type: ignore
except Exception:  # pragma: no cover
    charset_normalizer = None
try:
    import chardet  # type: ignore
except Exception:  # pragma: no cover
    chardet = None


def infer_encoding(data: bytes) -> Optional[str]:
    for lib in (cchardet, charset_normalizer, chardet):
        if lib is None:
            continue
        try:
            detected = lib.detect(data)["encoding"]
        except Exception:
            continue
        if detected is not None:
            return detected
    return None
