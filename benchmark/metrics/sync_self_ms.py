# -*- coding: utf-8 -*-
"""Self milliseconds per request of the program's root span (``sync``:
sync.run; ``batch``: batch.sync_batch): the time no span of the program
names (argument checks, duration probes, Python between the spans). Log
records (``log_ms``) and the PCM joins (``pcm_join_ms``) have spans of
their own and are not in it."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.self_ms()
