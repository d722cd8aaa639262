# -*- coding: utf-8 -*-
"""The port's sequence-parallel VAD (``ffsubsync_tpu_torch/parallel/
vad_shard.py``) against the JAX package's sharded program on its virtual
8-device CPU mesh (tests/conftest.py), and against the port's own
monolithic ``_vad_program`` (fresh state, one chunk), on meshes of CPU
"devices" that repeat one device. Bounds are tests/test_vad_shard.py's."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu.parallel.vad_shard import make_sharded_detector as jax_sharded_detector
from ffsubsync_tpu_torch.models.neural_vad import CONTEXT, load_net
from ffsubsync_tpu_torch.ops import vad as tvad
from ffsubsync_tpu_torch.ops.features import prepare_staged_input
from ffsubsync_tpu_torch.ops.frontend import wire_silence_rows
from ffsubsync_tpu_torch.parallel import vad_shard

torch.set_num_threads(1)

CPU = torch.device("cpu")
RATE = 8000
MODES = ["webrtc", "silero", "weighted"]
# tests/test_vad_shard.py: reduction-order drift (summed shard sums, the
# cross-shard affine composition) moves soft labels by ~1e-3
TOL, AGREEMENT, MAX_DIFF = 0.02, 0.999, 0.05


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("FFS_TPU_SP_VAD", raising=False)


def _pcm(seconds, spans):
    wav = speech_signal_for_spans(seconds, spans, RATE, speech_level=0.35)
    return np.clip(wav * 32767, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def pcm():
    """tests/test_vad_shard.py's 64 s 8 kHz signal (6,400 windows)."""
    return _pcm(64.0, [(3.0, 6.5), (12.0, 17.0), (25.0, 29.0), (40.0, 44.0), (55.0, 58.0)])


def _monolithic(pcm, mode):
    framed, rate, window, n = prepare_staged_input(pcm, RATE, 100)
    net = None if mode == "webrtc" else load_net(rate, CPU)
    labels, _state = tvad._vad_program(
        torch.from_numpy(framed), window, rate, n, tvad.initial_state(CPU), net, 0.0, mode
    )
    return labels.numpy().astype(np.float64)


def _assert_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    assert np.mean(diff < TOL) > AGREEMENT, "label agreement %.4f" % np.mean(diff < TOL)
    assert diff.max() < MAX_DIFF


@pytest.mark.parametrize("mode", MODES)
def test_sharded_labels_match_jax_sharded_program(pcm, mode):
    """8 shards each side; the JAX package pads every shard to a TILE_T
    multiple (1,024 rows), the port to ceil(n / D) (800 rows)."""
    mesh = Mesh(np.array(jax.devices()), ("time",))
    assert mesh.devices.size == 8
    want = np.asarray(jax_sharded_detector(mesh, mode, 100, RATE, 0.0)(pcm))
    got = np.asarray(vad_shard.make_sharded_detector([CPU] * 8, mode, 100, RATE, 0.0)(pcm))
    _assert_close(got, want)


@pytest.mark.parametrize("n_shards", [8, 3])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_labels_match_monolithic_program(pcm, mode, n_shards):
    det = vad_shard.make_sharded_detector([CPU] * n_shards, mode, 100, RATE, 0.0)
    shards, _window, _rate, n = det.stage(pcm)
    assert n == 6400
    assert [s.shape[0] for s in shards] == [-(-n // n_shards)] * n_shards
    _assert_close(np.asarray(det(pcm)), _monolithic(pcm, mode))


@pytest.mark.parametrize("mode", MODES)
def test_short_signal_pads_shards_with_wire_silence(monkeypatch, mode):
    """10 s (1,000 windows) over 8 shards: ceil(n / D) < CONTEXT, so every
    shard holds CONTEXT rows and the last five are all padding, in the
    packed 6-bit wire's silence pattern."""
    monkeypatch.setenv("FFS_TPU_WIRE", "mulaw6")
    pcm = _pcm(10.0, [(1.0, 3.0), (4.5, 7.0), (8.0, 9.5)])
    det = vad_shard.make_sharded_detector([CPU] * 8, mode, 100, RATE, 0.0)
    shards, window, rate, n = det.stage(pcm)
    assert n == 1000 and window == 80
    assert all(s.shape == (CONTEXT, 60) and s.dtype == torch.int8 for s in shards)
    silence = wire_silence_rows(shards[0].numpy(), CONTEXT, window)
    assert silence.any()  # not zero bytes
    np.testing.assert_array_equal(shards[-1].numpy(), silence)
    _assert_close(det.run(shards, window, rate, n).numpy().astype(np.float64),
                  _monolithic(pcm, mode))


def test_sharded_labels_drive_the_aligner_to_the_shift():
    from ffsubsync_tpu_torch.subs.raster import rasterize_intervals
    from ffsubsync_tpu_torch.ops.align import align_candidates

    spans = [(2.0, 5.0), (9.0, 13.0), (20.0, 24.0), (33.0, 37.0)]
    signal = vad_shard.make_sharded_detector([CPU] * 8, "weighted", 100, RATE, 0.0)(
        _pcm(42.0, spans)
    )
    assert isinstance(signal, tvad.LazySpeechSignal)
    shift = 1.75
    cand = rasterize_intervals([(a - shift, b - shift) for a, b in spans], 100)
    result = align_candidates(signal, [cand], max_offset_samples=500)[0]
    # the hangover extends span tails asymmetrically, which can move the
    # correlation argmax by one 10 ms window
    assert abs(result.offset - int(shift * 100)) <= 1


def test_shard_outputs_stay_on_their_devices(pcm):
    det = vad_shard.make_sharded_detector([CPU] * 3, "weighted", 100, RATE, 0.0)
    shards, window, rate, n = det.stage(pcm)
    assert [s.device for s in shards] == list(det.mesh)
    per_shard = vad_shard._sharded_program(shards, window, rate, n, det.nets, 0.0, "weighted")
    assert [lab.device for lab in per_shard] == list(det.mesh)
    assert [lab.shape[0] for lab in per_shard] == [s.shape[0] for s in shards]
    joined = det.run(shards, window, rate, n)
    assert joined.device == det.mesh[0] and joined.shape == (n,)
    signal = det(pcm)
    assert len(signal._parts) == 1 and signal.device == det.mesh[0]


def test_collectives_match_sequential_folds():
    rng = np.random.RandomState(0)
    parts = [torch.from_numpy(rng.randn(4).astype(np.float32)) for _ in range(5)]
    pref = vad_shard._exclusive_prefix(parts, torch.add, torch.zeros_like)
    for i, got in enumerate(pref):
        np.testing.assert_allclose(got.numpy(), sum(p.numpy() for p in parts[:i]) + 0.0, rtol=1e-6)
    suf = vad_shard._exclusive_suffix(parts, torch.minimum, lambda s: torch.full_like(s, np.inf))
    for i, got in enumerate(suf):
        want = np.min([p.numpy() for p in parts[i + 1 :]], axis=0) if i < 4 else np.full(4, np.inf)
        np.testing.assert_array_equal(got.numpy(), want)
    # affine maps compose in order: applying the prefix to y0 equals
    # applying each earlier shard's map in turn
    maps = [(torch.rand(3) + 0.5, torch.randn(3)) for _ in range(4)]
    ident = lambda s: (torch.ones_like(s[0]), torch.zeros_like(s[1]))  # noqa: E731
    y0 = torch.randn(3)
    for i, (a, b) in enumerate(vad_shard._exclusive_prefix(maps, vad_shard._compose_affine, ident)):
        y = y0
        for ma, mb in maps[:i]:
            y = ma * y + mb
        np.testing.assert_allclose((a * y0 + b).numpy(), y.numpy(), rtol=1e-5)
    np.testing.assert_allclose(vad_shard._all_sum(parts)[3].numpy(),
                               sum(p.numpy() for p in parts), rtol=1e-6)


def test_halos():
    parts = [torch.arange(10 * i, 10 * i + 6, dtype=torch.float32) for i in range(3)]
    left = vad_shard._left_halos(parts, 2, torch.full((2,), -1.0))
    right = vad_shard._right_halos(parts, 2)
    assert [h.tolist() for h in left] == [[-1.0, -1.0], [4.0, 5.0], [14.0, 15.0]]
    assert [h.tolist() for h in right] == [[10.0, 11.0], [20.0, 21.0], [0.0, 0.0]]


def _fit(path, monkeypatch, sp):
    from ffsubsync_tpu_torch.media.audio import VideoSpeechSource

    calls = {"sharded": 0, "chunked": 0}
    real_sharded, real_chunked = vad_shard._sharded_program, tvad._vad_program

    def sharded(*args, **kwargs):
        calls["sharded"] += 1
        return real_sharded(*args, **kwargs)

    def chunked(*args, **kwargs):
        calls["chunked"] += 1
        return real_chunked(*args, **kwargs)

    monkeypatch.setattr(vad_shard, "_sharded_program", sharded)
    monkeypatch.setattr(tvad, "_vad_program", chunked)
    if sp:
        monkeypatch.setenv("FFS_TPU_SP_VAD", "1")
    else:
        monkeypatch.delenv("FFS_TPU_SP_VAD", raising=False)
    src = VideoSpeechSource(vad="fused", sample_rate=100, frame_rate=RATE,
                            non_speech_label=0.0, device=CPU)
    src.fit(path)
    monkeypatch.setattr(vad_shard, "_sharded_program", real_sharded)
    monkeypatch.setattr(tvad, "_vad_program", real_chunked)
    return np.asarray(src.transform()), calls, src.signal_or_spec()


def _wav(tmp_path):
    from tests.helpers import write_wav

    path = str(tmp_path / "m.wav")
    write_wav(path, speech_signal_for_spans(26.0, [(2.0, 5.0), (9.0, 12.0), (18.0, 22.0)],
                                            RATE, speech_level=0.35), RATE)
    return path


def test_sp_vad_product_wiring(tmp_path, monkeypatch):
    """FFS_TPU_SP_VAD=1 on a (patched) 4-device mesh routes the buffered
    audio path through one sharded call; the labels agree with the
    chunked pipeline's (tests/test_vad_shard.py's bar) and stay lazy."""
    path = _wav(tmp_path)
    monkeypatch.setattr(vad_shard, "local_mesh", lambda device: (device,) * 4)
    normal, normal_calls, _sig = _fit(path, monkeypatch, sp=False)
    sharded, sp_calls, sig = _fit(path, monkeypatch, sp=True)
    assert normal_calls == {"sharded": 0, "chunked": 1}
    assert sp_calls == {"sharded": 1, "chunked": 0}
    assert isinstance(sig, tvad.LazySpeechSignal) and sig.device == CPU
    assert normal.shape == sharded.shape == (2600,)
    assert np.mean(np.abs(normal - sharded) < 1e-2) > 0.99


def test_gate_on_the_real_cpu_mesh(tmp_path, monkeypatch):
    """The real mesh of the CPU is one device: the gate stays closed and
    the WAV takes the chunked path even with FFS_TPU_SP_VAD=1."""
    monkeypatch.setenv("FFS_TPU_SP_VAD", "1")
    assert vad_shard.local_mesh(CPU) == (CPU,)
    assert vad_shard.maybe_sharded_detector("fused", 100, RATE, 0.0, CPU) is None
    _labels, calls, _sig = _fit(_wav(tmp_path), monkeypatch, sp=True)
    assert calls == {"sharded": 0, "chunked": 1}


@pytest.mark.parametrize(
    "vad, env, mesh_size, mode",
    [
        ("fused", "1", 4, "weighted"),
        ("fused:union", "1", 2, "union"),
        ("subs_then_webrtc", "1", 2, "webrtc"),
        ("silero", "1", 3, "silero"),
        ("auditok", "1", 4, None),
        ("fused", None, 4, None),
        ("fused", "1", 1, None),
    ],
)
def test_sharded_detector_gate(monkeypatch, vad, env, mesh_size, mode):
    monkeypatch.setattr(vad_shard, "local_mesh", lambda device: (device,) * mesh_size)
    if env is not None:
        monkeypatch.setenv("FFS_TPU_SP_VAD", env)
    det = vad_shard.maybe_sharded_detector(vad, 100, RATE, 0.0, CPU)
    if mode is None:
        assert det is None
    else:
        assert det.mode == mode and det.mesh == (CPU,) * mesh_size
        assert (det.nets[0] is None) == (mode == "webrtc")
