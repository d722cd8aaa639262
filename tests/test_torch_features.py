# -*- coding: utf-8 -*-
"""ffsubsync_tpu_torch frontend vs the JAX package: copied numpy helpers,
host staging, wire decodes, and the plain PyTorch frontend against the
jnp composition and the Pallas kernel (interpret mode). The CUDA kernel
itself is compared with the plain version on the card (chip_smoke.py and
the ``cuda``-marked test below)."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffsubsync_tpu_torch import native
from ffsubsync_tpu.models import neural_vad as jnv
from ffsubsync_tpu.ops import features as jfeat
from ffsubsync_tpu.ops.pallas import frontend as plf
from ffsubsync_tpu_torch.models import neural_vad as tnv
from ffsubsync_tpu_torch.ops import features as tfeat
from ffsubsync_tpu_torch.ops import frontend as tfe

torch.set_num_threads(1)

# the reference's own frontend tolerances (tests/test_pallas_frontend.py)
LOGMEL_TOL = dict(rtol=2e-3, atol=2e-3)
BANDS_TOL = dict(rtol=2e-3, atol=1e-5)
TOTAL_TOL = dict(rtol=1e-4)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _random_pcm(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 3000).clip(-32768, 32767).astype(np.int16)


@pytest.mark.parametrize("rate", [8000, 12000, 16000, 24000, 48000])
def test_numpy_helpers_equal_reference(rate):
    window = rate // 100
    n_freqs = window // 2 + 1
    np.testing.assert_array_equal(
        tfeat.mel_filterbank(n_freqs, rate, 40), jfeat.mel_filterbank(n_freqs, rate, 40)
    )
    np.testing.assert_array_equal(
        tfeat.band_selector_matrix(n_freqs, rate, window),
        jfeat.band_selector_matrix(n_freqs, rate, window),
    )
    assert tfeat.analysis_rate(rate, 100) == jfeat.analysis_rate(rate, 100)
    assert tfeat.frames_per_window(rate, 100) == jfeat.frames_per_window(rate, 100)
    pcm = _random_pcm(4 * window, seed=rate)
    np.testing.assert_array_equal(
        tfe.mulaw_encode_host(pcm), plf.mulaw_encode_host(pcm)
    )
    assert tnv.has_trained_weights(rate) == jnv.has_trained_weights(rate)
    # the port ships its own copy of the weights: same file, same bytes
    ours, theirs = tnv.default_weights_path(rate), jnv.default_weights_path(rate)
    assert ours == os.path.join(os.path.dirname(tnv.__file__), "weights",
                                os.path.basename(theirs))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_constants_and_shapes_equal_reference(monkeypatch):
    assert tnv.expected_param_shapes() == jnv.expected_param_shapes()
    assert (tnv.CONTEXT, tnv.N_MELS, tnv.DILATIONS) == (
        jnv.CONTEXT, jnv.N_MELS, jnv.DILATIONS
    )
    assert tfeat._MIN_ANALYSIS_RATE == jfeat._MIN_ANALYSIS_RATE
    monkeypatch.setenv("FFS_TPU_ANALYSIS_DECIMATE", "0")
    assert tfeat.analysis_rate(48000, 100) == jfeat.analysis_rate(48000, 100) == 48000
    for window, rows in ((120, 3), (80, 2)):
        for framed in (np.zeros((1, window * 3 // 4), np.int8), np.zeros((1, window), np.int16)):
            np.testing.assert_array_equal(
                tfe.wire_silence_rows(framed, rows, window),
                plf.wire_silence_rows(framed, rows, window),
            )


def test_wire_decodes_match_reference():
    codes = np.arange(-127, 128, dtype=np.int8)
    np.testing.assert_allclose(
        tfe.mulaw_decode(torch.from_numpy(codes)).numpy(),
        np.asarray(plf.mulaw_decode(jnp.asarray(codes))),
        rtol=1e-6,
    )
    rng = np.random.RandomState(5)
    for window in (80, 120, 480):
        packed = rng.randint(-128, 128, size=(7, window * 3 // 4)).astype(np.int8)
        np.testing.assert_allclose(
            tfe.unpack_mulaw6(torch.from_numpy(packed), window).numpy(),
            np.asarray(plf.unpack_mulaw6(jnp.asarray(packed), window)),
            rtol=1e-6,
        )
    # the packed silence pattern decodes to exact zeros
    silence = tfe.wire_silence_rows(np.zeros((1, 90), np.int8), 2, 120)
    assert not tfe.unpack_mulaw6(torch.from_numpy(silence), 120).any()


def _wire_frames(pcm, window, t, wire):
    if wire == "i16":
        return pcm.reshape(t, window)
    if wire == "mulaw":
        return plf.mulaw_encode_host(pcm).reshape(t, window)
    return native.stage_for_device_p6(pcm, 0, window, t)


def _assert_features_close(got, want):
    for a, b, tol in zip(got, want, (LOGMEL_TOL, BANDS_TOL, TOTAL_TOL)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("wire", ["i16", "mulaw", "mulaw6"])
@pytest.mark.parametrize("rate", [8000, 12000])
def test_frontend_plain_matches_pallas_interpret(rate, wire):
    window = rate // 100
    t = plf.TILE_T
    pcm = _random_pcm(t * window, seed=rate + len(wire))
    framed = _wire_frames(pcm, window, t, wire)
    mats = plf.make_frontend_mats(rate, window)
    want = plf.fused_frontend(jnp.asarray(framed), mats, interpret=True)
    got = tfe.frontend_plain(torch.from_numpy(np.ascontiguousarray(framed)), window, rate)
    _assert_features_close(got, want)


@pytest.mark.parametrize("wire", ["i16", "mulaw"])
@pytest.mark.parametrize("rate", [8000, 12000])
def test_frontend_plain_matches_jnp_frontend(rate, wire):
    window = rate // 100
    t = 300  # ragged: the jnp composition takes any window count
    pcm = _random_pcm(t * window, seed=3 * rate)
    flat = pcm if wire == "i16" else plf.mulaw_encode_host(pcm)
    n_freqs = window // 2 + 1
    want = jfeat._frontend_jnp(
        jnp.asarray(flat),
        jnp.asarray(jfeat.mel_filterbank(n_freqs, rate, 40)),
        jnp.asarray(jfeat.band_selector_matrix(n_freqs, rate, window)),
        window,
    )
    got = tfe.frontend_plain(torch.from_numpy(flat.reshape(t, window)), window, rate)
    _assert_features_close(got, want)


@pytest.mark.parametrize("wire", ["i16", "mulaw", "mulaw6"])
def test_staging_matches_reference_and_numpy_copy(monkeypatch, wire):
    """The port's staging equals the JAX package's (narrow, unbucketed), and
    its numpy path (no compiled host library) equals the native one."""
    monkeypatch.setenv("FFS_TPU_WIRE", wire)
    pcm = _random_pcm(48000 * 3 + 1234, seed=11)  # 48 kHz -> 12 kHz tier
    framed, rate, window, n_windows = tfeat.prepare_staged_input(pcm, 48000, 100)
    ref_framed, mats, ref_n = jfeat.prepare_staged_input(pcm, 48000, 100)
    assert (rate, window, n_windows) == (12000, 120, ref_n)
    width = framed.shape[1]
    np.testing.assert_array_equal(framed, np.asarray(ref_framed)[:n_windows, :width])
    monkeypatch.setattr(native, "_lib", None)
    framed_np, *_ = tfeat.prepare_staged_input(pcm, 48000, 100)
    np.testing.assert_array_equal(framed_np, framed)


def test_compute_frontend_matches_reference(monkeypatch):
    monkeypatch.setenv("FFS_TPU_DISABLE_PALLAS", "1")
    pcm = _random_pcm(48000 * 2 + 777, seed=12)
    lm_j, bands_j, total_j, nw_j = jfeat.compute_frontend(pcm, 48000, 100)
    lm, bands, total, nw = tfeat.compute_frontend(pcm, 48000, 100, torch.device("cpu"))
    assert nw == nw_j == lm.shape[0]
    _assert_features_close(
        (lm, bands, total),
        (np.asarray(lm_j)[:nw], np.asarray(bands_j)[:nw], np.asarray(total_j)[:nw]),
    )


def test_fused_frontend_on_cpu_is_the_plain_version():
    window, rate, t = 120, 12000, 37
    x = torch.from_numpy(plf.mulaw_encode_host(_random_pcm(t * window, 4)).reshape(t, window))
    before = tfe.fused_frontend.launches
    got = tfe.fused_frontend(x, window, rate)
    want = tfe.frontend_plain(x, window, rate)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tfe.fused_frontend.launches == before  # no kernel ran


@pytest.mark.parametrize(
    "dtype, width", [(torch.int16, 90), (torch.int8, 121), (torch.float32, 120)]
)
def test_wire_kind_rejects_unknown_layouts(dtype, width):
    with pytest.raises(ValueError):
        tfe.wire_kind(torch.zeros((4, width), dtype=dtype), 120)


def test_kernel_band_ranges_match_selector():
    """The kernel sums contiguous bin ranges; they equal the 0/1 selector."""
    for rate in (8000, 12000, 16000, 24000, 48000):
        window = rate // 100
        sel = tfeat.band_selector_matrix(window // 2 + 1, rate, window)
        lo_hi = tfe._band_ranges(rate, window)
        rebuilt = np.zeros_like(sel)
        for b in range(tfe.N_BANDS):
            rebuilt[lo_hi[b] : lo_hi[tfe.N_BANDS + b], b] = 1.0
        np.testing.assert_array_equal(rebuilt, sel)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["i16", "mulaw", "mulaw6"])
@pytest.mark.parametrize("rate", [8000, 12000, 16000, 24000, 48000])
def test_cuda_kernel_matches_plain(cuda_device, rate, wire):
    window = rate // 100
    t = 1037  # ragged
    framed = _wire_frames(_random_pcm(t * window, seed=rate), window, t, wire)
    x = torch.from_numpy(np.ascontiguousarray(framed)).to(cuda_device)
    before = tfe.fused_frontend.launches
    got = tfe.fused_frontend(x, window, rate)
    torch.cuda.synchronize()
    assert tfe.fused_frontend.launches == before + 1
    want = tfe.frontend_plain(x, window, rate)
    _assert_features_close([g.cpu() for g in got], [w.cpu().numpy() for w in want])
