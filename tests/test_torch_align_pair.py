# -*- coding: utf-8 -*-
"""The port's raw-signal alignment (``ops.align.align_signal_pair``,
``prepare_ref_pm`` and ``ops.align_device.align_signals``) against the JAX
package's: the cases of tests/test_alignment.py run through both packages
on both branches, the host one (numpy under ``FFS_TPU_HOST_ALIGN=1``, the
JAX package's default) and the device one (``FFS_TPU_HOST_ALIGN=0``, the
port's default: the port on the CPU through ``FFS_TORCH_DEVICE=cpu``, the
JAX package on CPU JAX)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffsubsync_tpu.ops import align as jalign
from ffsubsync_tpu.ops import align_device as jdevice
from ffsubsync_tpu.subs import raster as jraster
from ffsubsync_tpu_torch.ops import align as talign
from ffsubsync_tpu_torch.ops import align_device as tdevice
from ffsubsync_tpu_torch.subs.raster import RasterSpec

from tests.test_alignment import oracle_align

torch.set_num_threads(1)

SCORE_REL = 1e-5


@pytest.fixture(params=["host", "device"])
def branch(request, monkeypatch):
    """Both packages on one branch; on the device branch the port's search
    is counted, so each test shows that it ran there."""
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    calls = []
    if request.param == "device":
        monkeypatch.setenv("FFS_TPU_HOST_ALIGN", "0")
        real = tdevice.align_signals

        def counted(ref_pm, *args):
            calls.append(ref_pm.device)
            return real(ref_pm, *args)

        monkeypatch.setattr(tdevice, "align_signals", counted)
    else:
        monkeypatch.setenv("FFS_TPU_HOST_ALIGN", "1")
    yield request.param
    if request.param == "device" and not request.node.name.startswith("test_rejects_empty"):
        assert calls and set(calls) == {torch.device("cpu")}, calls
    else:
        assert not calls


def _pair(ref, sub, max_offset=None):
    """Both packages' alignment of one pair; offsets equal, scores within
    ``SCORE_REL``. Returns the port's."""
    got = talign.align_signal_pair(ref, sub, max_offset)
    want = jalign.align_signal_pair(ref, sub, max_offset)
    assert isinstance(got, talign.Alignment)
    assert got.offset == want.offset
    assert got.score == pytest.approx(want.score, rel=SCORE_REL)
    return got


def _shifted(ref, true_offset, n_sub):
    sub = np.zeros(n_sub)
    for t in range(n_sub):
        if 0 <= t + true_offset < len(ref):
            sub[t] = ref[t + true_offset]
    return sub


@pytest.mark.parametrize(
    "s1, s2, true_offset",
    [("111001", "11001", -1), ("1001", "1001", 0), ("10010", "01001", 1)],
)
def test_fft_alignment(branch, s1, s2, true_offset):
    assert _pair(s2, s1).offset == true_offset


@pytest.mark.parametrize(
    "refstring, substring",
    [
        (np.array([]), np.array([1, 0, 1])),
        (np.array([1, 0, 1]), np.array([])),
        (np.array([]), np.array([])),
    ],
)
def test_rejects_empty_speech(branch, refstring, substring):
    for pkg, exc in ((talign, talign.FailedToFindAlignmentException),
                     (jalign, jalign.FailedToFindAlignmentException)):
        with pytest.raises(exc, match="empty speech data"):
            pkg.align_signal_pair(refstring, substring)


@pytest.mark.parametrize("seed", range(5))
def test_matches_oracle_random(branch, seed):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(1000) > 0.7).astype(float)
    true_offset = int(rng.randint(-80, 80))
    sub = _shifted(ref, true_offset, 900)
    result = _pair(ref, sub, 200)
    oracle_score, oracle_off = oracle_align(ref, sub, max_offset_samples=200)
    assert result.offset == oracle_off == true_offset
    assert result.score == pytest.approx(oracle_score, abs=1e-2)


def test_offset_mask_excludes_negative_bound(branch):
    """Allowed offsets are (-max, max]: -max masked, +max kept."""
    rng = np.random.RandomState(0)
    ref = (rng.rand(400) > 0.5).astype(float)
    max_off = 10
    for true_offset in (max_off, -max_off):
        sub = _shifted(ref, true_offset, 300)
        result = _pair(ref, sub, max_off)
        _, oracle_off = oracle_align(ref, sub, max_offset_samples=max_off)
        assert result.offset == oracle_off
        if true_offset == max_off:
            assert result.offset == max_off


@pytest.mark.parametrize("max_offset", [None, 40])
def test_bitstring_input_equals_array_input(branch, max_offset):
    rng = np.random.RandomState(3)
    ref = (rng.rand(300) > 0.6).astype(int)
    sub = _shifted(ref, 23, 250).astype(int)
    as_text = _pair("".join(map(str, ref)), "".join(map(str, sub)), max_offset)
    as_array = _pair(ref, sub, max_offset)
    assert as_text == as_array
    assert as_text.offset == 23


def _spec(signal, weight=1.0):
    signal = np.asarray(signal, float)
    starts = np.nonzero(np.diff(np.concatenate([[0], signal])) > 0)[0]
    ends = np.nonzero(np.diff(np.concatenate([signal, [0]])) < 0)[0] + 1
    return RasterSpec(n_samples=len(signal), starts=starts.astype(np.int32),
                      ends=ends.astype(np.int32), weight=weight,
                      max_time=len(signal) / 100.0, sample_rate=100)


@pytest.mark.parametrize("kind", ["spec", "weighted_spec", "array", "soft_array"])
def test_prepare_ref_pm_equals_reference(kind, monkeypatch):
    """The ±1 reference signal, padded with zeros to the FFT length, equal
    to the JAX package's (a spec rasterized, an array mapped) on the device
    ``get_device`` names."""
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    rng = np.random.RandomState(4)
    signal = (rng.rand(700) > 0.6).astype(np.float64)
    ref = {
        "spec": lambda: _spec(signal),
        "weighted_spec": lambda: _spec(signal, weight=0.958),
        "array": lambda: signal,
        "soft_array": lambda: rng.rand(700).astype(np.float32),
    }[kind]()
    n = 2048
    got = talign.prepare_ref_pm(ref, n)
    jref = jraster.RasterSpec(**dataclasses.asdict(ref)) if isinstance(ref, RasterSpec) else ref
    want = np.asarray(jalign.prepare_ref_pm(jref, n))
    assert got.device == torch.device("cpu") and got.dtype == torch.float32
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[700:].any()


def test_prepare_ref_pm_takes_an_explicit_device(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cuda")  # not consulted
    got = talign.prepare_ref_pm(np.ones(3), 8, torch.device("cpu"))
    assert got.tolist() == [1.0, 1.0, 1.0, 0, 0, 0, 0, 0]


def test_device_branch_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cuda")
    monkeypatch.delenv("FFS_TPU_HOST_ALIGN", raising=False)  # the default: the device
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cuda"):
        talign.align_signal_pair("10110", "0110")
    monkeypatch.setenv("FFS_TPU_HOST_ALIGN", "1")
    assert talign.align_signal_pair("10110", "0110").offset == 1  # the host branch


@pytest.mark.parametrize("max_offset", [None, 200])
def test_default_is_the_device_branch(monkeypatch, max_offset):
    """Without ``FFS_TPU_HOST_ALIGN`` the port searches on the device
    ``get_device`` names (the CPU here), where the JAX package stays on the
    host; both find the same alignment."""
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FFS_TPU_HOST_ALIGN", raising=False)
    calls, real = [], tdevice.align_signals

    def counted(ref_pm, *args):
        calls.append(ref_pm.device)
        return real(ref_pm, *args)

    monkeypatch.setattr(tdevice, "align_signals", counted)
    rng = np.random.RandomState(6)
    ref = (rng.rand(1000) > 0.7).astype(float)
    sub = _shifted(ref, -57, 900)
    assert _pair(ref, sub, max_offset).offset == -57
    assert calls == [torch.device("cpu")]


@pytest.mark.parametrize("max_offset", [None, 300, 0], ids=["all", "max300", "max0"])
def test_align_signals_equals_reference_kernel(max_offset):
    """``align_signals`` against ``_align_signals_kernel`` on K = 3 random
    ±1 signals of different lengths: the same offsets, scores within
    ``SCORE_REL``."""
    rng = np.random.RandomState(5)
    ref = (rng.rand(1500) > 0.65).astype(np.float32)
    lengths = (1200, 900, 1400)
    subs = [_shifted(ref, shift, m) for shift, m in zip((-41, 7, 120), lengths)]
    n = talign.next_pow2(len(ref) + max(lengths))
    ref_pm = np.zeros(n, np.float32)
    ref_pm[: len(ref)] = 2 * ref - 1
    subs_pm = np.zeros((3, n), np.float32)
    for i, s in enumerate(subs):
        subs_pm[i, : len(s)] = 2 * s - 1
    windows = [talign.search_window(n, m, max_offset) for m in lengths]
    start_offs = np.array([w[0] for w in windows])
    cnts = np.array([w[1] for w in windows])
    (n_offsets,) = {w[2] for w in windows}
    want_scores, want_offs = jdevice._align_signals_kernel(
        jnp.asarray(ref_pm), jnp.asarray(subs_pm), jnp.asarray(start_offs, jnp.int32),
        jnp.asarray(cnts, jnp.int32), n, n_offsets)
    got_scores, got_offs = tdevice.align_signals(
        torch.from_numpy(ref_pm), torch.from_numpy(subs_pm), torch.from_numpy(start_offs),
        torch.from_numpy(cnts), n, n_offsets)
    assert got_offs.tolist() == np.asarray(want_offs).tolist()
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=SCORE_REL)
    if max_offset is None:
        assert got_offs.tolist() == [-41, 7, 120]
