# -*- coding: utf-8 -*-
"""The port's spans (``ffsubsync_tpu_torch.utils.tracing``) on small syncs on
the CPU: the request tree of a CLI sync and of a batch, the counts of each
span, tracing off, the profiler's trace, the bound."""
import concurrent.futures
import gc
import json
import subprocess
import sys
import threading

import pytest
import torch

from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.cli import make_parser
from ffsubsync_tpu_torch.media import embedded
from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu_torch.sync import run
from ffsubsync_tpu_torch.utils import tracing

from tests.helpers import write_wav

torch.set_num_threads(1)

RATE = 12000
CUES = [(5.0, 7.5), (12.25, 15.0), (21.0, 24.4), (31.7, 34.0), (40.0, 43.5), (51.0, 54.2),
        (61.0, 64.0)]
GRID = 7  # candidates of the default framerate grid: 1.0 and three ratios each way
# every span of a CLI sync of a WAV with the default flags (and ``log``,
# where the package's own log handler is the one installed)
SPANS = ("sync", "probe", "spawn", "detector", "read", "pcm_join", "stage", "vad_program",
         "progress", "parse", "raster", "align", "label_wait", "write")


def _srt(cues, shift=0.0):
    def ts(t):
        ms = int(round(t * 1000))
        return "%02d:%02d:%02d,%03d" % (ms // 3600000, ms // 60000 % 60, ms // 1000 % 60, ms % 1000)

    return "".join("%d\n%s --> %s\nline %d\n\n" % (i + 1, ts(a + shift), ts(b + shift), i)
                   for i, (a, b) in enumerate(cues))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FFS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A 67-s WAV whose speech matches CUES, and two subtitle files 2.2 s
    late."""
    d = tmp_path_factory.mktemp("tracing")
    wav = str(d / "ref.wav")
    write_wav(wav, speech_signal_for_spans(67.0, CUES, RATE, speech_level=0.35), RATE)
    subs = []
    for name in ("a.srt", "b.srt"):
        (d / name).write_text(_srt(CUES, 2.2))
        subs.append(str(d / name))
    return {"dir": d, "wav": wav, "subs": subs, "ref_srt": _write(d, "ref.srt", _srt(CUES))}


def _write(d, name, text):
    (d / name).write_text(text)
    return str(d / name)


def _sync(media, subs=None, flags=()):
    """A CLI sync of ``subs`` (default: the first subtitle file, written to
    an output file; several are synced in place)."""
    if subs is None:
        subs, flags = media["subs"][:1], ["-o", str(media["dir"] / "out.srt")] + list(flags)
    else:
        flags = ["--overwrite-input"] + list(flags)
    return run(make_parser().parse_args([media["wav"], "-i"] + subs + flags))


def _recorded(media, **kw):
    with tracing.recording() as rec:
        result = _sync(media, **kw)
    assert result["sync_was_successful"]
    return rec


@pytest.fixture(scope="module")
def one_sync(media):
    """One CLI sync with the default flags, recorded (after a first, warm-up
    sync)."""
    _sync(media)
    return _recorded(media)


def _self_seconds(spans):
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        covered, end = 0.0, float("-inf")
        for c in sorted(by_parent.get(s.id, []), key=lambda c: c.t0):
            a, b = max(c.t0, s.t0, end), min(c.t1, s.t1)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = (s.t1 - s.t0) - covered
    return out


def test_a_sync_is_one_root_request(one_sync):
    roots = [s for s in one_sync.spans if s.parent is None]
    assert [s.name for s in roots] == ["sync"]
    assert roots[0].request == roots[0].id
    assert one_sync.counts["sync"] == 1
    assert set(one_sync.counts) - {"log"} == set(SPANS)


def test_every_span_nests_in_its_parent_with_the_roots_request(one_sync):
    by_id = {s.id: s for s in one_sync.spans}
    root = next(s for s in one_sync.spans if s.parent is None)
    for s in one_sync.spans:
        assert s.request == root.id
        if s is root:
            continue
        parent = by_id[s.parent]
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1, (s, parent)
        assert s.thread == root.thread  # one thread: the CLI sync starts none
    assert by_id[next(s.parent for s in one_sync.spans if s.name == "label_wait")].name == "align"
    assert {by_id[s.parent].name for s in one_sync.spans if s.name == "parse"} == {"raster"}
    assert {by_id[s.parent].name for s in one_sync.spans if s.name == "spawn"} == {"probe"}


def test_self_times_sum_to_the_roots_wall(one_sync):
    root = next(s for s in one_sync.spans if s.parent is None)
    total = sum(_self_seconds(one_sync.spans).values())
    assert total == pytest.approx(root.t1 - root.t0, rel=0.01)


@pytest.mark.parametrize("files", [1, 2])
def test_parse_once_per_input_file_and_a_raster_per_candidate(media, tmp_path, files):
    """An audio reference infers no ratio: the grid's 7 candidates a file,
    one parse of each file (the candidates share a caching parser)."""
    subs = [_write(tmp_path, "in%d.srt" % i, _srt(CUES, 2.2)) for i in range(files)]
    rec = _recorded(media, subs=subs)
    assert rec.counts["parse"] == files
    assert rec.counts["raster"] == GRID * files
    assert rec.counts["align"] == rec.counts["label_wait"] == rec.counts["write"] == files


class _CountedPopen:
    """subprocess.Popen counted; ``fake`` answers instead of a process."""

    def __init__(self, fake=None):
        self.calls, self.fake, self.real = 0, fake, subprocess.Popen

    def __call__(self, args, **kwargs):
        self.calls += 1
        return self.fake(args) if self.fake else self.real(args, **kwargs)


class _Done:
    def __init__(self, rc, out=b""):
        self.returncode, self.out = rc, out

    def communicate(self):
        return self.out, b""


@pytest.mark.parametrize("fake", [
    None,  # the machine's own binaries, or none: each try is a spawn
    lambda args: _Done(1 if "ffprobe" in args[0] else 0),  # ffprobe fails, 5 empty streams
], ids=["machine", "ffprobe-fails"])
def test_spawn_once_per_process_the_probe_starts(media, monkeypatch, fake):
    popen = _CountedPopen(fake)
    monkeypatch.setattr(embedded.subprocess, "Popen", popen)
    rec = _recorded(media)
    assert popen.calls >= 1
    assert rec.counts["spawn"] == popen.calls
    if fake is not None:
        assert popen.calls == 6  # one ffprobe, then the first five streams one by one


@pytest.mark.parametrize("vad, loads", [(None, 0), ("fused", 1)])
def test_the_net_loads_under_fused_only(media, vad, loads):
    rec = _recorded(media, flags=["--vad", vad] if vad else [])
    assert rec.counts.get("net_load", 0) == loads
    assert rec.counts.get("net", 0) == (rec.counts["vad_program"] if loads else 0)
    by_id = {s.id: s for s in rec.spans}
    assert all(by_id[s.parent].name == "detector" for s in rec.spans if s.name == "net_load")


def test_off_records_nothing_and_opens_no_range(media, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    tracing.reset()
    assert tracing.span("read") is tracing.span("stage")  # the one shared no-op
    assert _sync(media)["sync_was_successful"]
    assert tracing.spans() == [] and entered == []
    assert tracing.counts().get("sync", 0) == 0
    # on without a profiler: kept, with no range for a profiler to record
    with tracing.recording() as rec:
        with tracing.span("read"):
            pass
    assert entered == [] and [s.name for s in rec.spans] == ["read"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("stage"):
            pass
    assert entered == ["stage"] and [s.name for s in tracing.spans()] == ["stage"]
    tracing.reset()


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _no_binary(args, **kwargs):
    raise FileNotFoundError(args[0])


def test_a_profiled_sync_holds_every_span_as_a_user_annotation(media, tmp_path, monkeypatch):
    """--profile-dir: the profiler's trace holds each span of the sync as a
    range of its name and length. The lengths are read on two clocks: the
    profiler's ranges of spans that make system calls (the probe's, the
    log's writes) read up to ~0.12 ms longer than ``perf_counter`` on a
    loaded CPU host, 5-10 us longer on pure computation; hence 5% or
    0.25 ms. The probe finds no binary without starting a process. The
    collector is held off for the sync: a collection that an allocation
    inside ``record_function``'s own entry or exit sets off (0.4 ms in a
    large test process) lengthens the range and not the span it holds."""
    monkeypatch.setattr(embedded.subprocess, "Popen", _no_binary)
    tracing.reset()
    prof = tmp_path / "prof"
    gc.disable()
    try:
        assert _sync(media, flags=["--profile-dir", str(prof)])["sync_was_successful"]
    finally:
        gc.enable()
    spans = tracing.spans()
    tracing.reset()
    assert {s.name for s in spans} - {"log"} == set(SPANS)
    ranges = _annotations(prof / "trace.json")
    for name in SPANS:
        ours = sorted((s for s in spans if s.name == name), key=lambda s: s.t0)
        theirs = sorted((e for e in ranges if e["name"] == name), key=lambda e: e["ts"])
        assert len(theirs) == len(ours), name
        for s, e in zip(ours, theirs):
            dur = (s.t1 - s.t0) * 1e6
            assert abs(float(e["dur"]) - dur) <= max(0.05 * dur, 250.0), (name, e["dur"], dur)


def _batch(media, refs, tmp_path):
    jobs = [(ref, media["subs"][i % 2], str(tmp_path / ("b%d.srt" % i)))
            for i, ref in enumerate(refs)]
    with tracing.recording() as rec:
        results = sync_batch(jobs, decode_workers=2)
    assert all(r["sync_was_successful"] for r in results), results
    return rec


def _under(spans, top):
    """The spans below ``top``, at any depth."""
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent, []).append(s)
    out, todo = [], [top.id]
    while todo:
        kids = by_parent.get(todo.pop(), [])
        out += kids
        todo += [k.id for k in kids]
    return out


def test_a_batch_extracts_on_its_workers_under_the_batch_request(media, tmp_path):
    rec = _batch(media, [media["wav"]] * 3, tmp_path)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["batch"]
    batch = roots[0]
    assert all(s.request == batch.id for s in rec.spans)
    extracts = [s for s in rec.spans if s.name == "extract"]
    assert len(extracts) == 3
    for ex in extracts:
        assert ex.parent == batch.id and ex.thread != batch.thread
        assert batch.t0 <= ex.t0 <= ex.t1 <= batch.t1
        below = _under(rec.spans, ex)
        assert {"probe", "detector", "read", "stage", "vad_program", "progress"} <= {
            s.name for s in below}
        assert all(s.thread == ex.thread for s in below)
    assert len({ex.thread for ex in extracts}) <= 2  # two decode workers
    # the candidates are parsed and rasterized on the batch's own thread
    assert rec.counts["raster"] == 3 * GRID and rec.counts["align"] == 1
    assert rec.counts["write"] == 3


def test_a_subtitle_reference_is_parsed_and_rasterized_under_its_extract(media, tmp_path):
    rec = _batch(media, [media["ref_srt"]] * 3, tmp_path)
    for ex in (s for s in rec.spans if s.name == "extract"):
        names = [s.name for s in _under(rec.spans, ex)]
        assert sorted(names) == ["parse", "raster"]


def test_spans_past_the_bound_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 5)
    with tracing.recording() as rec:
        for i in range(8):
            with tracing.span("s%d" % i):
                pass
    assert [s.name for s in rec.spans] == ["s%d" % i for i in range(5)]
    assert rec.dropped == 3 and sum(rec.counts.values()) == 8 and rec.counts["s7"] == 1


def test_spans_from_many_threads_are_all_counted_once(monkeypatch):
    """More threads than cores open spans at once, with the interpreter
    switching threads as often as it can: no span is lost or kept twice,
    ids stay unique, and the bound holds."""
    threads, each, limit = 16, 300, 4000
    monkeypatch.setattr(tracing, "LIMIT", limit)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            with tracing.span("top", root=True):
                with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                    def work():
                        for _ in range(each):
                            with tracing.span("leaf"):
                                pass
                    for f in [pool.submit(tracing.bind(work)) for _ in range(threads)]:
                        f.result(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert rec.counts == {"top": 1, "leaf": threads * each}
    assert len(rec.spans) == limit and rec.dropped == threads * each + 1 - limit
    assert len({s.id for s in rec.spans}) == limit
    # the root closes last, past the bound; every leaf names it as parent
    # and request
    root = rec.spans[0].parent
    assert root is not None and {(s.request, s.parent) for s in rec.spans} == {(root, root)}


def test_kept_spans_add_nothing_for_the_garbage_collector():
    """A store of many spans holds no object per span that the collector
    tracks (and walks in every full collection), and reads back each span
    whole."""
    gc.collect()
    with tracing.recording() as rec:
        before = len(gc.get_objects())
        with tracing.span("top", root=True):
            for _ in range(5000):
                with tracing.span("leaf"):
                    pass
        after = len(gc.get_objects())
    assert after - before < 100
    spans = rec.spans
    assert len(spans) == 5001 and spans[-1].name == "top" and spans[-1].parent is None
    assert {(s.request, s.parent) for s in spans[:-1]} == {(spans[-1].id, spans[-1].id)}
    assert all(s.t0 <= s.t1 and s.thread == spans[-1].thread for s in spans)


def test_bind_carries_the_request_to_a_worker_thread():
    def work():
        with tracing.span("inner"):
            return threading.get_native_id()

    with tracing.recording() as rec:
        with tracing.span("top", root=True):
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                bound = pool.submit(tracing.bind(work)).result()
                unbound = pool.submit(work).result()
    top = next(s for s in rec.spans if s.name == "top")
    inner = [s for s in rec.spans if s.name == "inner"]
    assert bound == unbound != top.thread
    # the bound task belongs to the request; the unbound one to none
    assert sorted((s.request, s.parent) for s in inner if s.request is not None) == [
        (top.id, top.id)]
    assert [(s.request, s.parent) for s in inner if s.request is None] == [(None, None)]


def test_counts_carry_the_launch_counters():
    from ffsubsync_tpu_torch.ops import frontend, scan

    with tracing.recording():
        with tracing.span("x"):
            pass
        got = tracing.counts()
    assert got["x"] == 1 and got["dropped"] == 0
    assert got["fused_frontend.launches"] == frontend.fused_frontend.launches
    assert got["scan.launches"] == scan.launches


def test_counters_count_on_and_off_apart_from_the_span_counts():
    tracing.reset()
    tracing.count("x.calls")
    tracing.count("x.calls", 2)
    assert tracing.counts()["x.calls"] == 3
    with tracing.recording() as rec:
        tracing.count("x.calls")
        with tracing.span("x"):
            pass
        got = tracing.counts()
    assert rec.counts == {"x": 1} and rec.counters == {"x.calls": 1}
    assert got["x"] == got["x.calls"] == 1
    assert tracing.counts()["x.calls"] == 3
    tracing.reset()
    assert "x.calls" not in tracing.counts()


def test_spanned_keeps_the_function():
    @tracing.spanned("work")
    def work(a, b=2):
        """Adds."""
        return a + b

    assert work.__name__ == "work" and work.__doc__ == "Adds."
    with tracing.recording() as rec:
        assert work(1, b=3) == 4
    assert rec.counts == {"work": 1}
