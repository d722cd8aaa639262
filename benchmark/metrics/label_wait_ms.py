# -*- coding: utf-8 -*-
"""Host milliseconds per request blocked on the device for the search's answer
(span ``label_wait``: the .cpu() of the scores and offsets in
ops/align.align_candidates and parallel/batch.BatchAligner.align_batch)."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("label_wait")
