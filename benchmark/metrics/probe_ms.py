# -*- coding: utf-8 -*-
"""Host milliseconds per request in the embedded-subtitle probe (span
``probe``: media/audio.VideoSpeechSource.fit around
try_fit_using_embedded_subs, its process spawns included), summed over
threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("probe")
