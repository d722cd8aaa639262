# -*- coding: utf-8 -*-
"""Host milliseconds per request joining a pipeline chunk's PCM (span
``pcm_join``: media/audio._join_pcm_parts, where a WAV's mapped pages are
read), summed over threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("pcm_join")
