# -*- coding: utf-8 -*-
"""The host's pass from PCM to the wire: the WAV reader's slices of one
memory map reach staging as one view (``media/audio._join_pcm_parts``), and
staging without decimation splits by window ranges over the process's
staging pool (``native._by_row_ranges``). Every wire, stage count, range
split and pool size gives the bytes of one unsplit library call and of the
numpy fallback; the counters say how often each engages."""
import ctypes
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ffsubsync_tpu_torch import native as tnative
from ffsubsync_tpu_torch.cli import make_parser
from ffsubsync_tpu_torch.media.audio import _join_pcm_parts
from ffsubsync_tpu_torch.media.wav import WavReader
from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu_torch.ops.features import prepare_staged_input
from ffsubsync_tpu_torch.sync import run
from ffsubsync_tpu_torch.utils import tracing
from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16

torch.set_num_threads(1)

WINDOW = 120  # samples per window at the 12 kHz analysis rate
SPLIT = 64  # the split threshold the bit-equality cases run at
WIRES = ("mulaw", "mulaw6", "i16")
WIDTH = {"mulaw": WINDOW, "mulaw6": WINDOW * 3 // 4, "i16": WINDOW}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _pcm(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 6000).clip(-32768, 32767).astype(np.int16)


def _lib():
    lib = tnative._get_lib()
    if lib is None:
        pytest.fail("g++ could not build csrc/ffs_native.cpp")
    return lib


@pytest.fixture
def pool(request, monkeypatch):
    """The staging pool replaced by one of ``request.param`` workers."""
    workers = request.param
    executor = ThreadPoolExecutor(workers) if workers > 1 else None
    monkeypatch.setattr(tnative, "_stage_pool", (workers, executor))
    monkeypatch.setattr(tnative, "STAGE_SPLIT_WINDOWS", SPLIT)
    yield workers
    if executor is not None:
        executor.shutdown()


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _one_call(pcm, decim_stages, t_pad, wire):
    """The wire bytes of one unsplit library call (``ffs_stage_i8``,
    ``ffs_stage_p6``; ``ffs_frame_i16`` after ``decimate2``)."""
    lib = _lib()
    out = np.empty((t_pad, WIDTH[wire]), np.int16 if wire == "i16" else np.int8)
    if wire == "mulaw":
        lib.ffs_stage_i8(_ptr(pcm, ctypes.c_int16), len(pcm), decim_stages, WINDOW, WINDOW,
                         t_pad, _ptr(out, ctypes.c_int8))
    elif wire == "mulaw6":
        lib.ffs_stage_p6(_ptr(pcm, ctypes.c_int16), len(pcm), decim_stages, WINDOW,
                         WIDTH[wire], t_pad, _ptr(out.view(np.uint8), ctypes.c_uint8))
    else:
        for _ in range(decim_stages):
            pcm = tnative.decimate2(pcm)
        lib.ffs_frame_i16(_ptr(pcm, ctypes.c_int16), len(pcm), WINDOW, WINDOW, t_pad,
                          _ptr(out, ctypes.c_int16))
    return out


def _staged(pcm, decim_stages, t_pad, wire):
    """The port's staging call of ``wire`` (the i16 wire decimates first,
    as ``prepare_staged_input`` does)."""
    if wire == "mulaw":
        return tnative.stage_for_device(pcm, decim_stages, WINDOW, WINDOW, t_pad)
    if wire == "mulaw6":
        return tnative.stage_for_device_p6(pcm, decim_stages, WINDOW, t_pad)
    for _ in range(decim_stages):
        pcm = tnative.decimate2(pcm)
    # clamped here, as the mulaw fallback clamps: the i16 fallback takes no
    # more than its windows (prepare_staged_input never passes more)
    return tnative.frame_for_device(pcm[: t_pad * WINDOW], WINDOW, WINDOW, t_pad, mulaw=False)


def _samples(rows, decim_stages, fill):
    """Input samples for ``rows`` windows after ``decim_stages`` stages:
    a ragged last window, more than ``rows`` windows (``t_pad`` clamps
    them), or data for half the rows (the rest padding)."""
    per_row = WINDOW << decim_stages
    n = {"ragged": rows * per_row - 37, "clamped": (rows + 9) * per_row + 5,
         "short": rows * per_row // 2 + 3}[fill]
    return _pcm(n, seed=rows * 7 + decim_stages)


# rows just under, at and over two ranges' worth, and many ranges' worth
ROWS = (2 * SPLIT - 1, 2 * SPLIT, 2 * SPLIT + 1, 16 * SPLIT + 5)


@pytest.mark.parametrize("pool", [1, 2, 16], indirect=True, ids=lambda w: "pool%d" % w)
@pytest.mark.parametrize("fill", ["ragged", "clamped", "short"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("decim_stages", [0, 1, 2])
@pytest.mark.parametrize("wire", WIRES)
def test_split_staging_is_bit_equal(wire, decim_stages, rows, fill, pool, monkeypatch):
    pcm = _samples(rows, decim_stages, fill)
    want = _one_call(pcm, decim_stages, rows, wire)
    with tracing.recording() as rec:
        got = _staged(pcm, decim_stages, rows, wire)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    splits = decim_stages == 0 or wire == "i16"  # i16 frames the decimated signal
    k = min(pool, rows // SPLIT) if splits else 1
    assert rec.counters["stage.calls"] == 1
    assert rec.counters["stage.ranges"] == max(k, 1)
    # the numpy fallback: one pass on this thread, the same bytes
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_stage_pool", (pool, None))
    np.testing.assert_array_equal(_staged(pcm, decim_stages, rows, wire), want)


@pytest.mark.parametrize("pool", [4], indirect=True)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("rate", [12000, 24000, 48000])
def test_prepare_staged_input_is_bit_equal(rate, wire, pool, monkeypatch):
    """The public staging call, every wire at 0, 1 and 2 stages, into a
    given array as the pinned path stages."""
    monkeypatch.setenv("FFS_TPU_WIRE", wire)
    decim_stages = {12000: 0, 24000: 1, 48000: 2}[rate]
    rows = 9 * SPLIT + 11
    pcm = _pcm(rows * (rate // 100) - 50, seed=rate)
    want = _one_call(pcm, decim_stages, rows, wire)
    out = np.full_like(want, 7)
    got, analysis, window, n_windows = prepare_staged_input(pcm, rate, 100, out=out)
    assert (analysis, window, n_windows) == (12000, WINDOW, rows) and got is out
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pool", [4], indirect=True)
@pytest.mark.parametrize("wire", WIRES)
def test_four_threads_staging_at_once_get_their_own_bytes(wire, pool):
    """Four callers (a batch's decode workers) on one shared pool of four,
    switching threads often: each gets its own signal's bytes."""
    pcms = [_pcm(23 * SPLIT * WINDOW - 13 * i, seed=100 + i) for i in range(4)]
    want = [_one_call(p, 0, 23 * SPLIT, wire) for p in pcms]
    got = [None] * 4

    def stage(i):
        for _ in range(5):
            got[i] = _staged(pcms[i], 0, 23 * SPLIT, wire)
            np.testing.assert_array_equal(got[i], want[i])

    errors = []

    def worker(i):
        try:
            stage(i)
        except Exception as e:  # reported below, with its thread
            errors.append((i, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_the_numpy_fallback_stays_on_the_callers_thread(monkeypatch):
    class NoPool:
        def submit(self, *_args):
            raise AssertionError("the fallback handed work to the pool")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_stage_pool", (8, NoPool()))
    monkeypatch.setattr(tnative, "STAGE_SPLIT_WINDOWS", SPLIT)
    pcm = _pcm(40 * SPLIT * WINDOW, seed=3)
    got = tnative.stage_for_device(pcm, 0, WINDOW, WINDOW, 40 * SPLIT)
    monkeypatch.undo()
    np.testing.assert_array_equal(got, _one_call(pcm, 0, 40 * SPLIT, "mulaw"))


def test_the_pool_has_a_thread_per_core_of_the_process():
    workers, executor = tnative._staging_pool()
    assert workers == len(os.sched_getaffinity(0))
    assert (executor is None) == (workers == 1)


@pytest.mark.parametrize("seconds, splits", [(60, False), (100, False), (45 * 60, True)])
def test_the_real_threshold_splits_a_chunk_and_not_a_segment(seconds, splits, monkeypatch):
    """At the shipped threshold: a 60-s segment (6,000 windows) and a
    streaming read (10,000) are one call, a 45-min chunk (270,000) is split,
    whatever the pool's size."""
    monkeypatch.setattr(tnative, "_stage_pool", (4, ThreadPoolExecutor(4)))
    pcm = _pcm(seconds * 12000, seed=seconds)
    with tracing.recording() as rec:
        prepare_staged_input(pcm, 12000, 100)
    assert rec.counters["stage.calls"] == 1
    assert rec.counters["stage.ranges"] == (4 if splits else 1)


# -- the join ---------------------------------------------------------------


def _wav(tmp_path, name, pcm, rate, channels=1):
    path = str(tmp_path / name)
    write_wav_i16(path, pcm, rate, channels=channels)
    return path


def _reader_parts(path, target_rate, chunk_seconds=1.0):
    return list(WavReader(path).iter_chunks(target_rate=target_rate, chunk_seconds=chunk_seconds))


def _join_counted(parts):
    with tracing.recording() as rec:
        joined = _join_pcm_parts(parts)
    return joined, rec.counters.get("pcm_join.views", 0), rec.counters.get("pcm_join.copies", 0)


def _want(parts):
    return b"".join(parts) if isinstance(parts[0], bytes) else np.concatenate(parts)


@pytest.mark.parametrize("seconds", [3.0, 3.5, 1.0])  # whole, a ragged last part, one part
def test_adjacent_map_slices_join_as_a_view(tmp_path, seconds):
    pcm = _pcm(int(seconds * 12000), seed=11)
    parts = _reader_parts(_wav(tmp_path, "a.wav", pcm, 12000), 12000)
    assert len(parts) == int(np.ceil(seconds))
    mapped = parts[0].base
    joined, views, copies = _join_counted(parts)
    assert np.shares_memory(joined, mapped) and (views, copies) == (1, 0)
    np.testing.assert_array_equal(joined, _want(parts))
    np.testing.assert_array_equal(joined, pcm)


def _resampled(tmp_path):
    return _reader_parts(_wav(tmp_path, "r.wav", _pcm(3 * 16000, seed=12), 16000), 12000)


def _downmixed(tmp_path):
    stereo = _pcm(2 * 3 * 12000, seed=13).reshape(-1, 2)
    return _reader_parts(_wav(tmp_path, "s.wav", stereo, 12000, channels=2), 12000)


def _map_slices(tmp_path, order):
    parts = _reader_parts(_wav(tmp_path, "m.wav", _pcm(4 * 12000, seed=14), 12000), 12000)
    return [parts[i] for i in order]


JOIN_COPIES = {
    "bytes": lambda tmp: [_pcm(1000, seed=i).tobytes() for i in range(3)],
    "gap": lambda tmp: _map_slices(tmp, [0, 2, 3]),
    "out_of_order": lambda tmp: _map_slices(tmp, [1, 0, 2]),
    "strided": lambda tmp: [p[::2] for p in _map_slices(tmp, [0, 1])],
    "resampled": _resampled,
    "downmixed": _downmixed,
}


@pytest.mark.parametrize("case", sorted(JOIN_COPIES))
def test_other_parts_are_copied(tmp_path, case):
    parts = JOIN_COPIES[case](tmp_path)
    assert len(parts) > 1
    joined, views, copies = _join_counted(parts)
    assert (views, copies) == (0, 1)
    if isinstance(joined, np.ndarray):
        assert not any(np.shares_memory(joined, p) for p in parts)
        np.testing.assert_array_equal(joined, _want(parts))
    else:
        assert joined == _want(parts)


# -- the counters over a sync -----------------------------------------------


CUES = [(5.0, 7.5), (12.25, 15.0), (21.0, 24.4), (31.7, 34.0), (40.0, 43.5), (51.0, 54.2),
        (61.0, 64.0), (80.0, 84.5), (101.0, 104.0), (120.0, 124.0), (141.0, 145.0)]


def _srt(cues, shift):
    def ts(t):
        ms = int(round(t * 1000))
        return "%02d:%02d:%02d,%03d" % (ms // 3600000, ms // 60000 % 60, ms // 1000 % 60, ms % 1000)

    return "".join("%d\n%s --> %s\nline %d\n\n" % (i + 1, ts(a + shift), ts(b + shift), i)
                   for i, (a, b) in enumerate(cues))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A 150-s speech WAV at 12 kHz (the analysis rate: no decimation) and
    at 48 kHz (two stages), and subtitles 2.2 s late."""
    d = tmp_path_factory.mktemp("staging")
    wavs = {}
    for rate in (12000, 48000):
        wavs[rate] = str(d / ("ref%d.wav" % rate))
        write_wav_i16(wavs[rate], speech_signal_for_spans(150.0, CUES, rate, speech_level=0.35),
                      rate)
    srt = d / "in.srt"
    srt.write_text(_srt(CUES, 2.2))
    return {"dir": d, "wavs": wavs, "srt": str(srt)}


def _counted_sync(media, rate):
    argv = [media["wavs"][rate], "-i", media["srt"], "-o", str(media["dir"] / "out.srt")]
    with tracing.recording() as rec:
        result = run(make_parser().parse_args(argv))
    assert result["sync_was_successful"]
    assert result["offset_seconds"] == pytest.approx(-2.2, abs=0.15)  # subtitles late
    return {**rec.counts, **rec.counters}


@pytest.fixture
def small_reads(monkeypatch):
    """30-s reads, 60-s pipeline chunks, and 1,000-window ranges on a pool
    of 4: a 150-s WAV is three chunks of two, two and one reads."""
    from ffsubsync_tpu_torch.media import audio

    monkeypatch.setattr(audio, "WINDOWS_PER_BUFFER", 3000)
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "60")
    monkeypatch.setattr(tnative, "_stage_pool", (4, ThreadPoolExecutor(4)))
    monkeypatch.setattr(tnative, "STAGE_SPLIT_WINDOWS", 1000)


def test_a_sync_of_a_wav_at_the_analysis_rate_joins_each_chunk_as_a_view(media, small_reads):
    """Every chunk's join is a view and its staging is split: 6,000, 6,000
    and 3,000 windows in 4, 4 and 3 ranges."""
    counts = _counted_sync(media, 12000)
    assert counts["pcm_join"] == counts["pcm_join.views"] == 3
    assert counts.get("pcm_join.copies", 0) == 0
    assert counts["stage"] == counts["stage.calls"] == 3
    assert counts["stage.ranges"] == 11


def test_a_decimating_wav_stages_in_one_call_per_chunk(media, small_reads):
    """The 48-kHz WAV's chunks join as views too, but each stages in one
    call: the half-band filter reads across a range's edge."""
    counts = _counted_sync(media, 48000)
    assert counts["pcm_join"] == counts["pcm_join.views"] == 3
    assert counts["stage.calls"] == counts["stage"] == 3
    assert counts["stage.ranges"] == counts["stage.calls"]


def test_a_multi_segment_sync_stages_each_segment_in_one_call(media):
    """Two 60-s segments (6,000 windows each) at the shipped threshold and
    pool: one view and one staging call each."""
    from ffsubsync_tpu_torch.media.segments import MultiSegmentVideoSpeechSource

    src = MultiSegmentVideoSpeechSource(
        vad="webrtc", sample_rate=100, frame_rate=12000, non_speech_label=0.0,
        device=torch.device("cpu"), segment_count=2, segment_duration=60)
    with tracing.recording() as rec:
        src.fit(media["wavs"][12000])
    assert rec.counters["pcm_join.views"] == 2 and rec.counters.get("pcm_join.copies", 0) == 0
    assert rec.counters["stage.calls"] == rec.counters["stage.ranges"] == 2
