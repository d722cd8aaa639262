# -*- coding: utf-8 -*-
"""Kernel B1 (csrc/frontend.cu, ``frontend_kernel``) against its roofline,
in percent: the frozen least time of the frontend's work on the windows of
every VAD program of the window (operations at the float32 peak or bytes
at the memory peak, whichever is larger: the operations, at every path's
shape) over the kernel's card time in the trace. Each launch the program
counted (``fused_frontend.launches``) is taken at the mean duration of the
recorded events, since the trace can drop events."""
from benchmark.harness import yardstick

KERNEL = "frontend_kernel"


def read(run):
    if run.trace is None or not run.programs:
        return None
    seconds, events = run.trace.kernel_seconds(KERNEL)
    launches = run.counters.get("frontend", 0)
    if not events or launches != len(run.programs):
        return None
    bound = sum(yardstick.frontend_bound_s(t, window, rate, row_bytes)
                for _k, t, _nv, row_bytes, window, rate in run.programs)
    return 100.0 * bound / (seconds / events * launches)
