# -*- coding: utf-8 -*-
"""The port's device alignment search (``align_specs`` through
``align_candidates``) against the JAX package's device kernel
(``_align_specs_kernel``), its host path and the independent oracle of
tests/test_alignment.py: the ``(-max, max]`` window, first maximum over
descending offsets, the exact rescore and ``max_offset=0``. Candidates
are the port's own :class:`RasterSpec`s; the JAX side gets copies made
with its class."""
import dataclasses

import numpy as np
import pytest
import torch

from ffsubsync_tpu.ops import align as jalign
from ffsubsync_tpu.subs import raster as jraster
from ffsubsync_tpu_torch.ops import align as talign
from ffsubsync_tpu_torch.subs.raster import RasterSpec
from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal

from tests.test_alignment import oracle_align

torch.set_num_threads(1)

CPU = torch.device("cpu")
SCORE_REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _spec(signal, n_samples=None, weight=1.0):
    signal = np.asarray(signal, float)
    starts = np.nonzero(np.diff(np.concatenate([[0], signal])) > 0)[0]
    ends = np.nonzero(np.diff(np.concatenate([signal, [0]])) < 0)[0] + 1
    n = len(signal) if n_samples is None else n_samples
    return RasterSpec(
        n_samples=n,
        starts=np.clip(starts, 0, n).astype(np.int32),
        ends=np.clip(ends, 0, n).astype(np.int32),
        weight=weight,
        max_time=n / 100.0,
        sample_rate=100,
    )


def _jax(x):
    """A port spec as the JAX package's class; arrays pass through."""
    if isinstance(x, RasterSpec):
        return jraster.RasterSpec(**dataclasses.asdict(x))
    return x


def _shifted(ref, true_offset, n_sub):
    sub = np.zeros(n_sub)
    for t in range(n_sub):
        if 0 <= t + true_offset < len(ref):
            sub[t] = ref[t + true_offset]
    return sub


def _both(ref, candidates, max_offset):
    port = talign.align_candidates(ref, candidates, max_offset, device=CPU)
    jax_cands = [_jax(c) for c in candidates]
    want = jalign.align_candidates(_jax(ref), jax_cands, max_offset, prefer_host=False)
    host = jalign.align_candidates(_jax(ref), jax_cands, max_offset, prefer_host=True)
    for p, w, h in zip(port, want, host):
        assert p.offset == w.offset == h.offset
        assert p.score == pytest.approx(w.score, rel=SCORE_REL)
        assert p.score == pytest.approx(h.score, rel=SCORE_REL)
    return port


@pytest.mark.parametrize("seed", range(5))
def test_matches_oracle_random(seed):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(1000) > 0.7).astype(float)
    true_offset = int(rng.randint(-80, 80))
    sub = _shifted(ref, true_offset, 900)
    (result,) = _both(ref, [_spec(sub)], 200)
    oracle_score, oracle_off = oracle_align(ref, sub, max_offset_samples=200)
    assert result.offset == oracle_off == true_offset
    assert result.score == pytest.approx(oracle_score, abs=1e-2)


def test_offset_window_excludes_negative_bound():
    rng = np.random.RandomState(0)
    ref = (rng.rand(400) > 0.5).astype(float)
    for true_offset in (10, -10):
        sub = _shifted(ref, true_offset, 300)
        (result,) = _both(ref, [_spec(sub)], 10)
        _, oracle_off = oracle_align(ref, sub, max_offset_samples=10)
        assert result.offset == oracle_off
    assert _both(ref, [_spec(_shifted(ref, 10, 300))], 10)[0].offset == 10


@pytest.mark.parametrize("ref_kind", ["spec", "array", "lazy"])
def test_batched_candidates_all_reference_kinds(ref_kind):
    rng = np.random.RandomState(1)
    ref = (rng.rand(2000) > 0.75).astype(float)
    candidates = [
        _spec(_shifted(ref, shift, 1500), weight=w)
        for shift, w in ((-30, 1.0), (0, 0.958), (17, 1.0))
    ]
    if ref_kind == "spec":
        ref_arg = _spec(ref)
    elif ref_kind == "array":
        ref_arg = ref
    else:
        ref_arg = LazySpeechSignal(
            [(torch.from_numpy(ref[:700]).float(), 700), (torch.from_numpy(ref[700:]).float(), 1300)]
        )
    port = talign.align_candidates(ref_arg, candidates, 100, device=CPU)
    want = jalign.align_candidates(ref, [_jax(c) for c in candidates], 100, prefer_host=False)
    assert [p.offset for p in port] == [w.offset for w in want] == [-30, 0, 17]
    for p, w in zip(port, want):
        assert p.score == pytest.approx(w.score, rel=SCORE_REL)


def test_zero_max_offset():
    spec = RasterSpec(
        n_samples=256,
        starts=np.array([10, 60], np.int32),
        ends=np.array([30, 90], np.int32),
        weight=1.0,
        max_time=2.56,
        sample_rate=100,
    )
    (result,) = _both(spec, [spec], 0)
    assert result.offset == 0


def test_no_max_offset_window():
    rng = np.random.RandomState(3)
    ref = (rng.rand(600) > 0.6).astype(float)
    sub = _shifted(ref, -45, 500)
    assert _both(ref, [_spec(sub)], None)[0].offset == -45


def test_torch_argmax_takes_the_first_maximum():
    """The descending-offset gather relies on it: on a tie the LARGEST
    offset (the first gathered) wins, as np.argmax does in the reference."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [float("-inf")] * 4])
    assert torch.argmax(x, dim=-1).tolist() == [1, 0]


def test_host_path_and_errors(monkeypatch):
    spec = _spec(np.r_[np.zeros(5), np.ones(15), np.zeros(44)])
    # prefer_host routes to the host path (a copy of the JAX package's): no
    # device needed
    assert talign.align_candidates(spec, [spec], prefer_host=True)[0].offset == 0
    monkeypatch.setenv("FFS_TPU_HOST_ALIGN", "1")
    assert talign.align_candidates(spec, [spec])[0].offset == 0
    monkeypatch.delenv("FFS_TPU_HOST_ALIGN")
    with pytest.raises(ValueError, match="device"):
        talign.align_candidates(spec, [spec])
    empty = RasterSpec(
        n_samples=0, starts=np.zeros(0, np.int32), ends=np.zeros(0, np.int32),
        weight=1.0, max_time=0.0, sample_rate=100,
    )
    with pytest.raises(talign.FailedToFindAlignmentException, match="empty speech"):
        talign.align_candidates(spec, [empty], device=CPU)
