# -*- coding: utf-8 -*-
"""Host milliseconds per request in ops.vad._vad_program, the enqueue of
each chunk's VAD program, summed over its threads."""


def read(run):
    spans = run.spans_of("vad")
    if not spans or not run.requests:
        return None
    return 1e3 * sum(t1 - t0 for _l, _k, _tid, t0, t1 in spans) / len(run.requests)
