# -*- coding: utf-8 -*-
"""Kernel B2 (csrc/scan.cu, ``scan_one_pass``) against its roofline, in
percent: the frozen bytes of the webrtc detector's eight scans per program,
worked out from its window count T (each input read once, each output
written once; the bytes bound), at the memory peak, over the kernel's card
time in the trace. Each launch the program counted (``ops.scan.launches``)
is taken at the mean duration of the recorded events."""
from benchmark.harness import yardstick

KERNEL = "scan_one_pass"
SCANS_PER_PROGRAM = 8


def read(run):
    if run.trace is None or not run.programs:
        return None
    seconds, events = run.trace.kernel_seconds(KERNEL)
    launches = run.counters.get("scan", 0)
    if not events or launches != SCANS_PER_PROGRAM * len(run.programs):
        return None
    bound = sum(yardstick.scan_bound_s(t) for _k, t, _nv, _rb, _w, _r in run.programs)
    return 100.0 * bound / (seconds / events * launches)
