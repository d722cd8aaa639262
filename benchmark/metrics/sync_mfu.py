# -*- coding: utf-8 -*-
"""The whole sync's share of the card's float32 peak, in percent: the
frozen operations of every request of the window (the frontend's of each
VAD program, the net's where it runs, each search's FFTs, products and
rescores) over the requests' wall seconds, at 67 TFLOP/s. It bounds every
kernel's share from above."""
from benchmark.harness import yardstick
from benchmark.harness.synth import FRAMERATE_RATIOS


def _search_len(run):
    """FFT length of one search: the reference's windows plus the longest
    candidate (the spans scaled by the largest ratio and moved by the
    largest offset), to the next power of two."""
    c, t = run.config, run.traffic
    windows = int(c["minutes"] * 60 * 100) + 2
    longest = int((c["minutes"] * 60 * max(FRAMERATE_RATIOS) + t["offset_bound_seconds"]) * 100) + 2
    return 1 << (windows + longest - 1).bit_length()


def read(run):
    if not run.requests:
        return None
    work = run.traffic.get("work", [])
    flops = 0.0
    for _k, t, _nv, row_bytes, window, rate in run.programs:
        flops += yardstick.frontend_work(t, window, rate, row_bytes)[0]
        if "net" in work:
            flops += yardstick.net_flops(t)
    jobs = sum(len(r["jobs"]) for r in run.requests)
    flops += yardstick.search_flops(_search_len(run), jobs, 1 + 2 * len(FRAMERATE_RATIOS))
    wall = sum(r["t1"] - r["t0"] for r in run.requests)
    return 100.0 * flops / wall / yardstick.PEAK_F32
