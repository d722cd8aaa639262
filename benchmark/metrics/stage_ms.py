# -*- coding: utf-8 -*-
"""Host milliseconds per request in ops.vad.stage_to_device (host staging of each chunk and its queued copy), summed over its threads."""


def read(run):
    spans = run.spans_of("stage")
    if not spans or not run.requests:
        return None
    return 1e3 * sum(t1 - t0 for _l, _k, _tid, t0, t1 in spans) / len(run.requests)
