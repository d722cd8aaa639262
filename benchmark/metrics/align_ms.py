# -*- coding: utf-8 -*-
"""Host milliseconds per request in the search (sync.align_candidates or BatchAligner.align_batch), its wait for the labels included."""


def read(run):
    spans = run.spans_of("align")
    if not spans or not run.requests:
        return None
    return 1e3 * sum(t1 - t0 for _l, _k, _tid, t0, t1 in spans) / len(run.requests)
