# -*- coding: utf-8 -*-
"""The VAD program's share of the card's float32 peak, in percent: the
frozen operations of the frontend and of the neural net over every program
of the window (dense 43 -> 96, seven convs of 96 x 96 x 5, dense 96 -> 1
over the chunk's windows and the 320 carried ones), over the card time of
the kernels launched inside the programs' ranges, at 67 TFLOP/s. Read only
where the net runs."""
from benchmark.harness import yardstick


def read(run):
    if run.trace is None or not run.programs or "net" not in run.traffic.get("work", []):
        return None
    seconds, events = run.trace.kernel_seconds(layer="vad")
    if not events:
        return None
    flops = sum(yardstick.frontend_work(t, window, rate, row_bytes)[0] + yardstick.net_flops(t)
                for _k, t, _nv, row_bytes, window, rate in run.programs)
    return 100.0 * flops / seconds / yardstick.PEAK_F32
