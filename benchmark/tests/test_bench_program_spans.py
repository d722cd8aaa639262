# -*- coding: utf-8 -*-
"""The readers of the program's own spans (``harness/program_spans.py``) on
a synthetic span list, and on a small traced cell on the CPU against the
recorder's spans of the same calls."""
import pytest

from benchmark.harness import program_spans, runner, spec
from benchmark.harness.runner import Run
from benchmark.tests.conftest import tiny
from ffsubsync_tpu_torch.utils.tracing import Span

NEW = ("sync_self_ms", "probe_ms", "detector_ms", "parse_ms", "raster_ms", "label_wait_ms",
       "progress_ms", "write_ms", "spawns_per_request", "pcm_join_ms", "log_ms")


def _s(name, i, parent, request, t0, t1, tid=1):
    return Span(name, i, parent, request, tid, t0, t1)


# two requests of one second each; request 1 is a batch whose two extracts
# run at once on threads 2 and 3
SPANS = [
    _s("sync", 1, None, 1, 0.10, 0.90),
    _s("probe", 2, 1, 1, 0.10, 0.20),
    _s("spawn", 3, 2, 1, 0.10, 0.15),
    _s("spawn", 4, 2, 1, 0.15, 0.18),
    _s("detector", 5, 1, 1, 0.20, 0.25),
    _s("raster", 6, 1, 1, 0.30, 0.40),
    _s("parse", 7, 6, 1, 0.30, 0.35),
    _s("raster", 8, 1, 1, 0.40, 0.45),
    _s("align", 9, 1, 1, 0.50, 0.60),
    _s("label_wait", 10, 9, 1, 0.55, 0.60),
    _s("progress", 11, 1, 1, 0.60, 0.61),
    _s("write", 12, 1, 1, 0.80, 0.85),
    _s("pcm_join", 13, 1, 1, 0.45, 0.50),
    _s("log", 14, 1, 1, 0.65, 0.67),
    _s("log", 15, 2, 1, 0.18, 0.19),  # a record inside the probe
    _s("batch", 20, None, 20, 1.10, 1.90),
    _s("extract", 21, 20, 20, 1.10, 1.50, tid=2),
    _s("extract", 22, 20, 20, 1.20, 1.60, tid=3),
    _s("probe", 23, 21, 20, 1.10, 1.20, tid=2),
    _s("probe", 24, 22, 20, 1.20, 1.30, tid=3),
    _s("raster", 25, 20, 20, 1.60, 1.70),
    _s("write", 26, 20, 20, 1.80, 1.85),
    _s("pcm_join", 27, 21, 20, 1.30, 1.35, tid=2),
    _s("log", 28, 20, 20, 1.70, 1.72),
    # a root outside every request (a sync before the window), and a span
    # of no request
    _s("sync", 30, None, 30, 2.10, 2.20),
    _s("write", 31, 30, 30, 2.10, 2.15),
    _s("parse", 40, None, None, 0.70, 0.75),
]


def _run():
    return Run(requests=[{"k": 0, "t0": 0.0, "t1": 1.0, "jobs": [{}]},
                         {"k": 1, "t0": 1.0, "t1": 2.0, "jobs": [{}]}],
               spans=[], programs=[], counters={}, trace=None, config={}, traffic={},
               window_s=2.0)


def read(name, run):
    return spec.metric_reader(name).read(run)


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(program_spans, "_program_spans", lambda: list(SPANS))


def test_the_requests_of_the_roots(synthetic):
    got = program_spans.of(_run())
    assert sorted(got.by_request) == [0, 1]
    assert {s.id for s in got.by_request[1]} == set(range(20, 29))
    assert 30 not in {s.id for spans in got.by_request.values() for s in spans}


@pytest.mark.parametrize("name, want", [
    ("probe_ms", (100 + 200) / 2),  # request 1: two threads at once, summed
    ("detector_ms", 50 / 2),
    ("parse_ms", 50 / 2),  # the span of no request is left out
    # self time: request 0's first raster less its parse (50), the second
    # whole (50); request 1's 100
    ("raster_ms", (50 + 50 + 100) / 2),
    ("label_wait_ms", 50 / 2),
    ("progress_ms", 10 / 2),
    ("write_ms", (50 + 50) / 2),
    ("spawns_per_request", 2 / 2),
    ("pcm_join_ms", (50 + 50) / 2),  # request 1's inside an extract
    ("log_ms", (20 + 10 + 20) / 2),  # the probe's record too
    # request 0: 800 less probe, detector, two rasters, align, progress,
    # write, the join and the root's record (100 + 50 + 150 + 100 + 10 +
    # 50 + 50 + 20); request 1: 800 less the extracts' union (500), the
    # raster, the write and the record (170)
    ("sync_self_ms", ((800 - 530) + (800 - 670)) / 2),
])
def test_each_reader_on_a_span_list(synthetic, name, want):
    assert read(name, _run()) == pytest.approx(want)


def test_a_program_without_spans_reports_nothing(monkeypatch):
    for spans in (None, [], [_s("sync", 30, None, 30, 2.10, 2.20)]):
        monkeypatch.setattr(program_spans, "_program_spans", lambda spans=spans: spans)
        for name in NEW:
            assert read(name, _run()) is None, (name, spans)


@pytest.mark.parametrize("limit, whole", [(4, True), (3, False)])
def test_a_window_whose_spans_were_dropped_reports_nothing(monkeypatch, limit, whole):
    """A store that dropped spans past its bound kept part of the window:
    its per-request means would leave requests out unseen."""
    from ffsubsync_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "LIMIT", limit)
    with tracing.recording():
        with tracing.span("sync", root=True):
            for name in ("parse", "raster", "write"):
                with tracing.span(name):
                    pass
        run = Run(requests=[{"k": 0, "t0": 0.0, "t1": float("inf"), "jobs": [{}]}],
                  spans=[], programs=[], counters={}, trace=None, config={}, traffic={},
                  window_s=1.0)
        got = program_spans.of(run)
    assert (got is not None) == whole
    assert (read("write_ms", run) is not None) == whole


# the recorder's layer of each span the program opens at the same call
SAME_CALL = {"read": "read", "stage": "stage", "vad_program": "vad", "align": "align"}


@pytest.mark.parametrize("cell", ["film90-default", "season10-default"])
def test_a_traced_cell_reports_the_program_spans_beside_the_recorders(
        cell, monkeypatch, cpu_program):
    """A traced run on the CPU: the eleven readers report numbers, and each
    span the recorder keeps around a read step, a staging, a VAD program or
    a search holds, or sits in, the program's own span of the same call, on
    the same thread. The two differ by the outer one's instrument alone:
    the recorder's generator step around the program's read, the
    profiler's range (0.02-0.2 ms on a CPU host) around each of the others,
    and in a batch whatever the decode workers do while they hold the
    interpreter; the VAD programs and the searches agree within 5%."""
    runs = []

    class Kept(Run):
        def __init__(self, **kw):
            super().__init__(**kw)
            runs.append(self)

    monkeypatch.setattr(runner, "Run", Kept)
    line, rc = runner.run(cell, 7, 1.0, True, require_cuda=False, overrides=tiny(cell))
    assert rc == 0 and line["correct"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(metrics)
    assert metrics["spawns_per_request"] >= 1 and metrics["raster_ms"] > 0
    assert metrics["pcm_join_ms"] > 0 and metrics["log_ms"] >= 0
    ours = program_spans.of(runs[0])
    program = [s for spans in ours.by_request.values() for s in spans]
    for name, layer in SAME_CALL.items():
        theirs = [x for x in runs[0].spans if x[0] == layer]
        mine = [s for s in program if s.name == name]
        assert len(mine) == len(theirs) > 0, name
        for _l, _k, tid, t0, t1 in theirs:
            same = [s for s in mine if s.thread == tid and s.t0 < t1 and t0 < s.t1]
            assert len(same) == 1, (name, t0)
            ours_s, theirs_s = same[0].t1 - same[0].t0, t1 - t0
            outer, inner = (ours_s, theirs_s) if name == "read" else (theirs_s, ours_s)
            assert outer >= inner, (name, outer, inner)
            if cell.startswith("film90"):  # one thread: the gap is the instrument's alone
                assert outer - inner <= 1e-3, (name, outer, inner)
    assert ours.total_ms("vad_program") == pytest.approx(metrics["vad_issue_ms"], rel=0.05)
    assert ours.total_ms("align") == pytest.approx(metrics["align_ms"], rel=0.05)
