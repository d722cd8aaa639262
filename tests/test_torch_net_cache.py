# -*- coding: utf-8 -*-
"""``neural_vad.load_net``'s process-wide net: read once per weights file
(path, ``st_mtime_ns``, size), rate and device, and shared by every caller.

Each call is an acquisition (``net_load.calls``); a read is counted apart
(``net_load.reads``). The shared net is the one a fresh read gives, bit for
bit, and a fused batch writes the same bytes and hands its searches the
same labels with a cold cache and a warm one, on the CPU and on the card.
"""
import concurrent.futures
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

from benchmark.harness.spans import Recorder
from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.models import neural_vad
from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu_torch.utils import tracing
from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16

torch.set_num_threads(1)

RATE = 12000  # analysis rate of the default 12 kHz frame rate
CPU = torch.device("cpu")
SECONDS = 40.0
CUES = [(3.0, 6.0), (9.5, 12.0), (15.0, 19.5), (23.0, 25.5), (29.0, 33.0)]


@pytest.fixture(autouse=True)
def _cold():
    neural_vad.clear_net_cache()
    yield
    neural_vad.clear_net_cache()


def _weights(path, seed):
    params = neural_vad.init_params(torch.Generator().manual_seed(seed))
    np.savez(path, **{k: v.numpy() for k, v in params.items()})
    return str(path)


def _patch_path(monkeypatch, path):
    monkeypatch.setattr(neural_vad, "default_weights_path", lambda rate=None: path)


def _acquire(n=1):
    """``n`` acquisitions on the CPU; returns the nets and the counters."""
    with tracing.recording() as rec:
        nets = [neural_vad.load_net(RATE, CPU) for _ in range(n)]
    return nets, {k: rec.counters.get(k, 0) for k in ("net_load.calls", "net_load.reads")}


def _state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def test_two_acquisitions_share_one_read_of_the_shipped_weights():
    (first, second), counters = _acquire(2)
    assert second is first
    assert counters == {"net_load.calls": 2, "net_load.reads": 1}
    shared = _state(first)
    neural_vad.clear_net_cache()
    (fresh,), counters = _acquire()
    assert fresh is not first and counters["net_load.reads"] == 1
    got = _state(fresh)
    assert shared.keys() == got.keys()
    for k in shared:
        assert torch.equal(shared[k], got[k]), k


def test_the_shared_net_is_read_only():
    (net,), _ = _acquire()
    assert not net.training
    assert not any(p.requires_grad for p in net.parameters())


@pytest.mark.parametrize("change", ["mtime", "size", "path"])
def test_a_changed_or_other_weights_file_is_read_again(monkeypatch, tmp_path, change):
    path = _weights(tmp_path / "net.npz", 0)
    _patch_path(monkeypatch, path)
    st = os.stat(path)
    (before,), _ = _acquire()
    if change == "mtime":
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    elif change == "size":  # the same weights, compressed, at the same time
        np.savez_compressed(path, **neural_vad.params_to_numpy(before))
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
        assert os.path.getsize(path) != st.st_size
    else:
        _patch_path(monkeypatch, _weights(tmp_path / "other.npz", 0))
    (after,), counters = _acquire()
    assert after is not before
    assert counters == {"net_load.calls": 1, "net_load.reads": 1}
    (again,), counters = _acquire()
    assert again is after and counters["net_load.reads"] == 0


def test_a_rewritten_file_of_the_same_size_and_time_is_read_after_a_clear(monkeypatch,
                                                                           tmp_path):
    """The trainer's case: ``clear_net_cache`` after writing makes the next
    acquisition read what was written, whatever the file's identity."""
    path = _weights(tmp_path / "net.npz", 0)
    _patch_path(monkeypatch, path)
    st = os.stat(path)
    (before,), _ = _acquire()
    _weights(tmp_path / "net.npz", 1)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.path.getsize(path) == st.st_size
    (stale,), _ = _acquire()
    assert stale is before  # the same identity: no read
    neural_vad.clear_net_cache()
    (after,), counters = _acquire()
    assert counters["net_load.reads"] == 1
    assert not torch.equal(after.inp.weight, before.inp.weight)


def test_four_threads_at_once_read_once_and_share_the_net(monkeypatch):
    real = neural_vad._read_net
    reading = threading.Event()

    def slow_read(path, device):
        reading.set()
        threading.Event().wait(0.2)  # the other threads arrive while one reads
        return real(path, device)

    monkeypatch.setattr(neural_vad, "_read_net", slow_read)
    start = threading.Barrier(4, timeout=30)

    def acquire():
        start.wait()
        return neural_vad.load_net(RATE, CPU)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                futures = [pool.submit(acquire) for _ in range(4)]
                nets = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert reading.is_set()
    assert all(net is nets[0] for net in nets)
    assert rec.counters.get("net_load.calls") == 4
    assert rec.counters.get("net_load.reads") == 1
    assert rec.counts.get("net_read") == 1 and rec.counts.get("net_load") == 4


def test_the_fallback_warns_on_every_acquisition(monkeypatch, tmp_path, caplog):
    _patch_path(monkeypatch, str(tmp_path / "none.npz"))
    with caplog.at_level(logging.WARNING, logger=neural_vad.__name__):
        (first, second, third), counters = _acquire(3)
    assert first is second is third
    assert counters == {"net_load.calls": 3, "net_load.reads": 1}
    warned = [r for r in caplog.records if "no usable neural VAD weights" in r.getMessage()]
    assert len(warned) == 3


def test_stale_weights_warn_twice_on_every_acquisition(monkeypatch, tmp_path, caplog):
    path = str(tmp_path / "stale.npz")
    np.savez(path, w_in=np.zeros((3, 3), np.float32))
    _patch_path(monkeypatch, path)
    with caplog.at_level(logging.WARNING, logger=neural_vad.__name__):
        _nets, counters = _acquire(2)
    assert counters["net_load.reads"] == 1
    messages = [r.getMessage() for r in caplog.records]
    assert sum("predate the current architecture" in m for m in messages) == 2
    assert sum("no usable neural VAD weights" in m for m in messages) == 2


def test_a_cpu_device_is_one_key_however_named():
    assert neural_vad._device_key(CPU) == CPU
    assert neural_vad._device_key("cpu") == CPU


def _srt(cues, shift):
    def ts(t):
        ms = int(round(t * 1000))
        return "%02d:%02d:%02d,%03d" % (ms // 3600000, ms // 60000 % 60, ms // 1000 % 60,
                                        ms % 1000)

    return "".join("%d\n%s --> %s\nline %d\n\n" % (i + 1, ts(a + shift), ts(b + shift), i)
                   for i, (a, b) in enumerate(cues))


@pytest.fixture(scope="module")
def films(tmp_path_factory):
    """Three 40-s WAVs at 12 kHz and their subtitles, each shifted."""
    d = tmp_path_factory.mktemp("net_cache")
    out = []
    for f, shift in enumerate((1.7, -0.9, 2.4)):
        wav = str(d / ("film%d.wav" % f))
        write_wav_i16(wav, speech_signal_for_spans(SECONDS, CUES, RATE, seed=f,
                                                   speech_level=0.35), RATE)
        srt = d / ("in%d.srt" % f)
        srt.write_text(_srt(CUES, shift))
        out.append((wav, str(srt)))
    return d, out


def _fused_batch(films, tag):
    """One fused batch of the three films on 2 decode workers: (written
    bytes per job, labels per job, counters)."""
    d, pairs = films
    jobs = [(wav, srt, str(d / ("%s%d.srt" % (tag, j)))) for j, (wav, srt) in enumerate(pairs)]
    with tracing.recording() as trace, Recorder() as rec:
        rec.begin(0, True)
        results = sync_batch(jobs, vad="fused", decode_workers=2)
        rec.end()
    assert all(r["error"] is None and r["sync_was_successful"] for r in results), results
    (refs, _candidates, _alignments), = rec.searches[0]
    written = []
    for _wav, _srt_path, out in jobs:
        with open(out, "rb") as f:
            written.append(f.read())
    counters = {k: trace.counters.get(k, 0) for k in ("net_load.calls", "net_load.reads")}
    return written, [np.asarray(r, np.float64) for r in refs], counters


def _cold_and_warm(films, monkeypatch, device):
    monkeypatch.setenv("FFS_TORCH_DEVICE", device)
    cold = _fused_batch(films, "cold_%s_" % device)
    warm = _fused_batch(films, "warm_%s_" % device)
    assert cold[2] == {"net_load.calls": 3, "net_load.reads": 1}
    assert warm[2] == {"net_load.calls": 3, "net_load.reads": 0}
    assert cold[0] == warm[0]
    assert len(cold[1]) == len(warm[1]) == 3
    for a, b in zip(cold[1], warm[1]):
        assert a.shape == b.shape == (int(SECONDS * 100),)
        assert np.array_equal(a, b)


def test_a_fused_batch_is_the_same_with_a_cold_and_a_warm_net(films, monkeypatch):
    _cold_and_warm(films, monkeypatch, "cpu")


@pytest.mark.cuda
def test_a_fused_batch_on_the_card_is_the_same_with_a_cold_and_a_warm_net(films, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _cold_and_warm(films, monkeypatch, "cuda")
    key = neural_vad._device_key(torch.device("cuda"))
    assert key == torch.device("cuda", torch.cuda.current_device())
    assert neural_vad.load_net(RATE, torch.device("cuda")) is neural_vad.load_net(RATE, key)
