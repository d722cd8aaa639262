# -*- coding: utf-8 -*-
"""The arithmetic of the frontend kernel (csrc/frontend.cu) on the CPU: the
Hann spectrum from the plain one's neighbours, the 3xTF32 split of the
cos | sin basis in mma fragment order, the sparse mel sums and the band
ranges, each against ``frontend_plain`` under ``chip_smoke.TOLS`` at every
tier and wire. The kernel, and the tile shape it chooses for itself, run
only on the card (``chip_smoke.py`` phase 3, the ``cuda``-marked tests
here and in tests/test_torch_features.py)."""
import numpy as np
import pytest
import torch

from chip_smoke import TOLS
from ffsubsync_tpu_torch import native
from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu_torch.ops import frontend as fe
from ffsubsync_tpu_torch.ops.features import mel_filterbank

torch.set_num_threads(1)

WIRES = {"i16": fe.WIRE_I16, "mulaw": fe.WIRE_MULAW, "mulaw6": fe.WIRE_MULAW6}
# the five tiers with trained weights or the legacy file, and two windows
# the kernel must take although no tier has them: 44.1 kHz audio stays at
# 44.1 kHz (window 441, odd) and 22.05 kHz at 22.05 kHz (window 220)
RATES = (8000, 12000, 16000, 24000, 48000, 22050, 44100)
CASES = [(rate, wire) for rate in RATES for wire in WIRES
         if wire != "mulaw6" or (rate // 100) % 4 == 0]
T = 211  # windows: ragged, and several 16-row mma tiles


def _pcm(rate, kind):
    window = rate // 100
    n = T * window
    rng = np.random.RandomState(rate)
    if kind == "random":
        return (rng.randn(n) * 3000).clip(-32768, 32767).astype(np.int16)
    if kind == "tone":  # a loud tone over quiet noise: weak bins of loud frames
        t = np.arange(n) / rate
        x = 30000 * np.sin(2 * np.pi * 1234.5 * t) + rng.randn(n) * 30
        return x.clip(-32768, 32767).astype(np.int16)
    speech = speech_signal_for_spans(n / rate + 0.01, [(0.3, 1.2), (1.5, 2.0)], rate,
                                     speech_level=0.35)
    return np.clip(speech[:n] * 32767, -32768, 32767).astype(np.int16)


def _framed(pcm, window, wire):
    if wire == "i16":
        return torch.from_numpy(pcm.reshape(-1, window))
    if wire == "mulaw":
        return torch.from_numpy(fe.mulaw_encode_host(pcm).reshape(-1, window))
    return torch.from_numpy(native.stage_for_device_p6(pcm, 0, window, len(pcm) // window))


def _hann_from_neighbours(c, s, window):
    """The kernel's epilogue: ``Xh[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1])``
    with ``X[-1] = conj X[1]`` and ``X[F] = conj X[W-F]``, on ``X = C - iS``
    given as ``[T, F]`` columns ``c`` and ``s``."""
    f = window // 2 + 1
    k = np.arange(f)
    km = np.where(k == 0, 1, k - 1)
    kn = np.where(k == f - 1, window - f, k + 1)
    sm = np.where(k == 0, -1.0, 1.0)
    sn = np.where(k == f - 1, -1.0, 1.0)
    ch = 0.5 * c - 0.25 * (c[:, km] + c[:, kn])
    sh = 0.5 * s - 0.25 * (sm * s[:, km] + sn * s[:, kn])
    return ch, sh


def _unfragment(frag):
    """The ``[k, n]`` hi and lo halves of the basis in fragment order
    (ops/frontend.split_basis): lane ``(g, tig)`` of (ks, nt) holds rows
    ``8ks + 2tig`` and ``8ks + 2tig + 1`` of column ``8nt + g``."""
    hi, lo = np.zeros((2, frag.shape[0] * 8, frag.shape[1] * 8), np.float32)
    lane = np.arange(32)
    for ks in range(frag.shape[0]):
        for nt in range(frag.shape[1]):
            k, n = 8 * ks + 2 * (lane % 4), 8 * nt + lane // 4
            hi[k, n], hi[k + 1, n] = frag[ks, nt, :, 0], frag[ks, nt, :, 1]
            lo[k, n], lo[k + 1, n] = frag[ks, nt, :, 2], frag[ks, nt, :, 3]
    return hi, lo


def _features_from_spectrum(c, s, raw, window, rate):
    """What the kernel computes from ``[C | S]``: log-mel of the Hann power
    from the identity over each filter's nonzero bin run, the bands over
    their bin ranges, and the total power from the samples."""
    ch, sh = _hann_from_neighbours(c, s, window)
    p_hann, p_plain = ch * ch + sh * sh, c * c + s * s
    lo, hi, weights = fe.mel_ranges(rate, window)
    mel = np.zeros((len(c), fe.N_MELS))
    o = 0
    for m in range(fe.N_MELS):
        mel[:, m] = p_hann[:, lo[m]: hi[m]] @ weights[o: o + hi[m] - lo[m]]
        o += hi[m] - lo[m]
    ranges = fe._band_ranges(rate, window)
    bands = np.stack([p_plain[:, ranges[b]: ranges[fe.N_BANDS + b]].sum(axis=1)
                      for b in range(fe.N_BANDS)], axis=1)
    total = (raw.astype(np.float64) ** 2).mean(axis=1)
    return np.log(mel + fe.LOG_MEL_EPS), bands, total


def _assert_within_tols(got, want, what):
    for (name, (rtol, atol)), a, b in zip(TOLS.items(), got, want):
        b = b.numpy().astype(np.float64)
        assert a.shape == b.shape, (what, name)
        bad = np.abs(a - b) > atol + rtol * np.abs(b)
        assert not bad.any(), (what, name, int(bad.sum()), float(np.abs(a - b).max()))


@pytest.mark.parametrize("kind", ["random", "speech", "tone"])
@pytest.mark.parametrize("rate,wire", CASES)
def test_hann_from_neighbours_matches_plain(rate, wire, kind):
    """The identity applied to ``torch.fft.rfft`` of the unwindowed frame
    gives frontend_plain's log-mel (Hann window), bands and total."""
    window = rate // 100
    x = _framed(_pcm(rate, kind), window, wire)
    raw = fe.wire_to_frame(x, window)
    spec = torch.fft.rfft(raw / 32768.0, dim=-1)
    got = _features_from_spectrum(spec.real.double().numpy(), -spec.imag.double().numpy(),
                                  raw.numpy(), window, rate)
    _assert_within_tols(got, fe.frontend_plain(x, window, rate), (rate, wire, kind))


# the basis widths the kernel's shapes pad to: 2 * n_freqs rounded up to
# the columns of one pass (64 to 512)
@pytest.mark.parametrize("per_pass", [64, 512])
@pytest.mark.parametrize("rate,wire", CASES)
def test_split_basis_product_matches_plain(rate, wire, per_pass):
    """The kernel's product: the samples split to tf32 hi/lo, the basis
    read back from its mma fragment order, hi*hi + hi*lo + lo*hi, then the
    epilogue; against frontend_plain on speech-like PCM."""
    window = rate // 100
    n_cols = -(-2 * (window // 2 + 1) // per_pass) * per_pass
    x = _framed(_pcm(rate, "speech"), window, wire)
    raw = fe.wire_to_frame(x, window).numpy()
    b_hi, b_lo = _unfragment(fe.split_basis(window, n_cols))
    kp = b_hi.shape[0]
    for part in (b_hi, b_lo):  # tf32: the low 13 mantissa bits are zero
        assert not (part.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_allclose(b_hi.astype(np.float64) + b_lo,
                               fe.dft_basis(window, n_cols), rtol=0, atol=2e-12)
    a = np.zeros((len(raw), kp), np.float32)
    a[:, :window] = raw
    a_hi = fe._tf32(a)
    a_lo = fe._tf32(a - a_hi)
    a_hi, a_lo = a_hi.astype(np.float64), a_lo.astype(np.float64)
    cs = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    f = window // 2 + 1
    assert not cs[:, 2 * f:].any()  # padding columns stay zero
    got = _features_from_spectrum(cs[:, :f], cs[:, f: 2 * f], raw, window, rate)
    _assert_within_tols(got, fe.frontend_plain(x, window, rate), (rate, wire))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", sorted({r // 100 for r in RATES} | {2, 7, 100, 511}))
def test_kernel_config_fits_one_block(cuda_device, window):
    """The shape the kernel chooses fits sm_90's 227 KB of shared memory
    per block, and its basis width covers cos | sin in whole passes."""
    for wire in WIRES.values():
        if wire == fe.WIRE_MULAW6 and window % 4:
            continue
        cfg = fe.kernel_config(window, wire)
        assert cfg.rows in (32, 64, 128) and 0 < cfg.smem <= 232448
        assert cfg.n_cols >= 2 * (window // 2 + 1) and cfg.n_cols % 64 == 0
    with pytest.raises(RuntimeError):
        fe.kernel_config(512, fe.WIRE_I16)  # n_freqs 257: no room for its mel weights


@pytest.mark.cuda
def test_main_path_config(cuda_device):
    """The 45-minute chunk's shape: 12 kHz, mu-law int8; the basis stays
    resident and one pass covers all 128 columns (2 x 61 bins padded)."""
    assert fe.kernel_config(120, fe.WIRE_MULAW)[:4] == (128, 64, 128, True)


@pytest.mark.parametrize("rate", RATES)
def test_mel_ranges_rebuild_the_filterbank(rate):
    window = rate // 100
    lo, hi, weights = fe.mel_ranges(rate, window)
    fb = mel_filterbank(window // 2 + 1, rate, fe.N_MELS)
    rebuilt = np.zeros_like(fb)
    o = 0
    for m in range(fe.N_MELS):
        rebuilt[lo[m]: hi[m], m] = weights[o: o + hi[m] - lo[m]]
        o += hi[m] - lo[m]
    np.testing.assert_array_equal(rebuilt, fb)
    assert len(weights) <= 512  # csrc/frontend.cu kMaxMelWeights


@pytest.mark.parametrize("rate", RATES)
def test_kernel_tables_layout(rate):
    """The buffer the kernel copies as its struct Tables."""
    window = rate // 100
    tab = fe.kernel_tables(rate, window)
    assert tab.dtype == np.int32 and tab.nbytes == fe._TABLES_BYTES
    lo, hi, weights = fe.mel_ranges(rate, window)
    m = fe.N_MELS
    np.testing.assert_array_equal(tab[:m], lo)
    np.testing.assert_array_equal(tab[m: 2 * m], hi)
    np.testing.assert_array_equal(tab[2 * m: 3 * m], np.concatenate([[0], np.cumsum(hi - lo)[:-1]]))
    assert tuple(tab[3 * m: 3 * m + 2 * fe.N_BANDS]) == fe._band_ranges(rate, window)
    floats = tab[3 * m + 2 * fe.N_BANDS:].view(np.float32)
    np.testing.assert_array_equal(floats[: len(weights)], weights)
    assert not floats[len(weights):].any()
