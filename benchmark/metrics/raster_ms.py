# -*- coding: utf-8 -*-
"""Host self milliseconds per request of the candidates' rasters (span
``raster``: speech.SubtitleSpeechSource.fit, the scale and
subs/raster.rasterize_cues; the parse it starts left out), summed over
threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.self_ms("raster")
