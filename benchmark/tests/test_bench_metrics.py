# -*- coding: utf-8 -*-
"""The per-layer readers on a synthetic span list and a synthetic trace."""
import json

import pytest

from benchmark.harness import spec, yardstick
from benchmark.harness.runner import Run
from benchmark.harness.trace import Trace

T = 270000


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "bench.window", 1000, 1000),
    _x("gpu_user_annotation", "bench.window", 1150, 600, tid=7),
    _x("cuda_runtime", "cudaLaunchKernel", 1150, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 1160, 5, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 1300, 5, corr=3),
    _x("kernel", "void (anonymous namespace)::frontend_kernel<128, 64, true>(Params)", 1210, 100,
       tid=7, corr=1),
    _x("kernel", "void scan_one_pass<AddF32, 2>(Params)", 1320, 50, tid=7, corr=2),
    _x("kernel", "void at::native::reduce_kernel<512>()", 1400, 100, tid=7, corr=3),
    _x("kernel", "void outside_the_window()", 3000, 100, tid=7, corr=4),
    _x("cpu_op", "aten::add", 1010, 1),
]
# the recorder's spans on the host clock (seconds): the window opened at
# 5.0 s, which the trace's clock calls 1000 us
HOST = [("request", 1, 5.0, 5.0005), ("request", 1, 5.0005, 5.001),
        ("stage", 1, 5.00005, 5.0001), ("vad", 1, 5.0001, 5.0002)]


def _run(trace=True, work=("frontend", "scan", "search")):
    spans = [("stage", 0, 1, 0.050, 0.100), ("vad", 0, 1, 0.100, 0.200),
             ("read", 1, 2, 0.600, 0.610), ("align", 1, 1, 0.650, 0.700),
             ("read", 1, 3, 0.605, 0.615)]
    return Run(requests=[{"k": 0, "t0": 0.0, "t1": 0.5, "jobs": [{}]},
                         {"k": 1, "t0": 0.5, "t1": 1.0, "jobs": [{}]}],
               spans=spans, programs=[(0, T, T, 120, 120, 12000)],
               counters={"frontend": 1, "scan": 8},
               trace=Trace(EVENTS, HOST, 5.0) if trace else None,
               config=spec.config("film90"), traffic={"work": list(work),
                                                       "offset_bound_seconds": 50},
               window_s=1.0)


def read(name, run):
    return spec.metric_reader(name).read(run)


def test_trace_reduction():
    tr = Trace(EVENTS, HOST, 5.0)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(250e-6)
    assert [k[2] for k in tr.kernels] == ["vad", "vad", "sync_rest"]
    assert tr.idle == pytest.approx({"vad": 210e-6, "sync_rest": 540e-6})
    bd = tr.breakdown()
    assert bd["device_ops"][0][1] == pytest.approx(100e-6) and len(bd["device_ops"]) == 3
    assert bd["idle_gaps"][0] == ["sync_rest", pytest.approx(540e-6)]
    json.dumps(bd)


def test_span_readers():
    run = _run()
    assert read("stage_ms", run) == pytest.approx(25.0)
    assert read("vad_issue_ms", run) == pytest.approx(50.0)
    assert read("read_ms", run) == pytest.approx(10.0)
    assert read("align_ms", run) == pytest.approx(25.0)
    # request 0: 500 ms less 150 covered; request 1: 500 less 15 (two
    # overlapping reads) and 50
    assert read("sync_rest_ms", run) == pytest.approx(((500 - 150) + (500 - 65)) / 2)


def test_trace_readers():
    run = _run()
    assert read("vad_card_ms", run) == pytest.approx(0.075)
    assert read("device_idle_pct", run) == pytest.approx(75.0)
    bound_fe = yardstick.frontend_bound_s(T, 120, 12000, 120)
    assert read("frontend_roofline", run) == pytest.approx(100 * bound_fe / 100e-6)
    # eight launches counted, one event recorded: each at the mean
    assert read("scan_roofline", run) == pytest.approx(100 * yardstick.scan_bound_s(T) / 400e-6)
    assert read("vad_mfu", run) is None  # the net does not run here
    fused = _run(work=("frontend", "scan", "net", "search"))
    flops = yardstick.frontend_work(T, 120, 12000, 120)[0] + yardstick.net_flops(T)
    assert read("vad_mfu", fused) == pytest.approx(100 * flops / 150e-6 / 67e12)


def test_readers_without_a_trace_or_events_return_nothing():
    run = _run(trace=False)
    for name in ("vad_card_ms", "device_idle_pct", "frontend_roofline", "scan_roofline",
                 "vad_mfu"):
        assert read(name, run) is None
    run = _run()
    run.counters = {"frontend": 2, "scan": 8}  # a launch the programs do not account for
    assert read("frontend_roofline", run) is None


def test_sync_mfu_counts_every_request():
    run = _run()
    n = 1 << 21  # 540,002 + the longest candidate: 90 min x 25/23.976 + 50 s
    flops = (yardstick.frontend_work(T, 120, 12000, 120)[0]
             + yardstick.search_flops(n, 2, 7))
    assert read("sync_mfu", run) == pytest.approx(100 * flops / 1.0 / 67e12)
