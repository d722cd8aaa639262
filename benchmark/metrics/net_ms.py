# -*- coding: utf-8 -*-
"""Host milliseconds per request in the neural VAD's forward calls (span
``net``: the net's call inside ops/vad._vad_program, on the thread that
issues it: the CLI's, or in a batch each decode worker's), summed over
threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("net")
