# -*- coding: utf-8 -*-
"""Host milliseconds per request in the progress reporter (span ``progress``:
utils/progress.ProgressReporter's enter, each update and exit: the tqdm bar,
the callback), summed over threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("progress")
