# -*- coding: utf-8 -*-
"""The neural VAD's box means (``models/neural_vad._box_mean``): on the CPU
from float32 prefix sums, as the reference; on CUDA from each box summed
directly (``_box_sums``), which gives the same bits on every run where
CUDA's one-dimensional ``cumsum`` does not. Both against a float64 box
mean."""
import numpy as np
import pytest
import torch

from ffsubsync_tpu_torch.models import neural_vad as nv

torch.set_num_threads(1)


def _series(t, seed):
    """A movie-like aux series: a positive level with runs of silence, and a
    valid run that starts and ends inside the array."""
    rng = np.random.RandomState(seed)
    v = (np.abs(rng.randn(t)) * rng.uniform(0.5, 3.0, t // 100 + 1).repeat(100)[:t])
    v[rng.rand(t) < 0.2] = 0.0
    vm = np.zeros(t)
    vm[t // 50: t - t // 40] = 1.0
    return v.astype(np.float32), vm.astype(np.float32)


def _box_mean_f64(v, vm, k, rows=None):
    """The box mean in float64, of the first ``rows`` rows (all by default)."""
    v, vm = np.asarray(v, np.float64), np.asarray(vm, np.float64)
    t = len(v)
    out = np.empty(t if rows is None else rows)
    for i in range(len(out)):
        lo, hi = max(0, i - k), min(t, i + k + 1)
        out[i] = (v[lo:hi] * vm[lo:hi]).sum() / max(vm[lo:hi].sum(), 1.0)
    return out


@pytest.mark.parametrize("k", [15, 30])
def test_box_sums_are_the_clipped_window_sums(k):
    v, vm = _series(5000, k)
    x = torch.from_numpy(v * vm)
    got = nv._box_sums(x, k).numpy()
    want = np.array([np.float64(v * vm)[max(0, i - k): i + k + 1].sum() for i in range(len(v))])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a batch of series: each row alone
    both = nv._box_sums(torch.stack([x, 2 * x]), k).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_allclose(both[1], 2 * got, rtol=1e-6)
    counts = nv._box_sums(torch.from_numpy(vm), k).numpy()
    assert np.array_equal(counts, np.round(counts)) and counts.max() == 2 * k + 1


def _within_summation_bound(got, want, k):
    """A float32 sum of 2k + 1 non-negative terms, then one division: each
    within (2k + 2) units of the last place of the exact mean."""
    return bool(np.all(np.abs(got - want) <= (2 * k + 2) * 2.0 ** -24 * np.abs(want)))


@pytest.mark.parametrize("k, nonneg", [(15, False), (30, True)])
def test_the_direct_and_the_prefix_box_means_agree_with_float64(k, nonneg):
    """At 60,000 rows the float32 prefix sums lose 5.2e-4 of the largest
    mean to cancellation; the direct sums keep each mean within the float32
    summation bound."""
    v, vm = _series(60000, 7)
    want = _box_mean_f64(v, vm, k)
    prefix = nv._box_mean(torch.from_numpy(v), torch.from_numpy(vm), k, nonneg=nonneg).numpy()
    direct = (nv._box_sums(torch.from_numpy(v * vm), k)
              / torch.clamp(nv._box_sums(torch.from_numpy(vm), k), min=1.0)).numpy()
    assert _within_summation_bound(direct, want, k)
    assert np.abs(prefix - want).max() <= 2e-3 * np.abs(want).max()


@pytest.mark.cuda
def test_the_card_box_mean_gives_the_same_bits_on_every_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v, vm = _series(264320, 3)  # a 44-min chunk and the carried context
    want = _box_mean_f64(v, vm, 30, rows=20000)
    dv, dvm = torch.from_numpy(v).cuda(), torch.from_numpy(vm).cuda()
    runs = [nv._box_mean(dv, dvm, 30, nonneg=True).cpu().numpy() for _ in range(5)]
    for r in runs[1:]:
        assert np.array_equal(r, runs[0])
    assert _within_summation_bound(runs[0][:20000], want, 30)
