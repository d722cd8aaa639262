# -*- coding: utf-8 -*-
"""Card milliseconds per request of the kernels launched inside
ops.vad._vad_program's range, from the profiler's trace."""


def read(run):
    if run.trace is None or not run.requests:
        return None
    seconds, events = run.trace.kernel_seconds(layer="vad")
    return 1e3 * seconds / len(run.requests) if events else None
