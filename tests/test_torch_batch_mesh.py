# -*- coding: utf-8 -*-
"""The port's batch search over a device mesh: ``BatchAligner(mesh)``
splits the batch into one group per device and gives every job the
result of the one-device call; ``sync_batch(..., mesh=...)`` takes the
JAX package's keyword; ``local_mesh`` lists the local devices."""
import inspect

import numpy as np
import pytest
import torch

from ffsubsync_tpu.batch import sync_batch as jax_sync_batch
from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.device import local_mesh
from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal
from ffsubsync_tpu_torch.parallel.batch import BatchAligner

from tests.test_batch import _make_job
from tests.test_torch_batch import _random_case

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("mesh_size", [2, 3, 7, 9])
def test_mesh_search_equals_one_device(mesh_size):
    """B = 7 jobs, lazy and host refs mixed, over meshes that divide the
    batch unevenly, one job per device, and more devices than jobs."""
    refs, cands = _random_case(np.random.RandomState(11), 7)
    refs = [LazySpeechSignal([torch.from_numpy(r)]) if i % 2 else r for i, r in enumerate(refs)]
    one = BatchAligner([CPU]).align_batch(refs, cands, max_offset_samples=250)
    mesh = BatchAligner([CPU] * mesh_size).align_batch(refs, cands, max_offset_samples=250)
    assert [len(m) for m in mesh] == [len(c) for c in cands]
    for got, want in zip(mesh, one):
        assert [a.offset for a in got] == [a.offset for a in want]
        for g, w in zip(got, want):
            assert g.score == pytest.approx(w.score, rel=1e-6)


def test_mesh_groups_are_contiguous(monkeypatch):
    """7 jobs over 3 devices: one stacked call per device, of 3, 2 and 2
    consecutive jobs."""
    import ffsubsync_tpu_torch.parallel.batch as pbatch

    seen = []
    real = pbatch.align_specs

    def recording(ref_pm, *args):
        seen.append(ref_pm.shape[0])
        return real(ref_pm, *args)

    monkeypatch.setattr(pbatch, "align_specs", recording)
    refs, cands = _random_case(np.random.RandomState(3), 7)
    out = BatchAligner([CPU] * 3).align_batch(refs, cands)
    assert seen == [3, 2, 2]
    assert len(out) == 7


def test_default_mesh_is_the_local_mesh():
    assert BatchAligner().mesh == local_mesh(CPU) == (CPU,)
    with pytest.raises(ValueError, match="at least one device"):
        BatchAligner([])


def test_local_mesh_lists_every_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert local_mesh(torch.device("cuda")) == tuple(
        torch.device("cuda", i) for i in range(3)
    )
    assert local_mesh(torch.device("cuda", 1)) == local_mesh(torch.device("cuda"))


def test_sync_batch_takes_the_reference_signature():
    """Every parameter of the JAX package's sync_batch, ``mesh`` included,
    in the same order."""
    assert list(inspect.signature(sync_batch).parameters) == list(
        inspect.signature(jax_sync_batch).parameters
    )


def test_sync_batch_on_a_mesh_writes_the_default_outputs(tmp_path):
    shifts = [3.0, -1.25, 0.75, 2.5, -0.5]
    jobs = [_make_job(tmp_path, "d%d" % i, s, kind="npz" if i == 2 else "srt")
            for i, s in enumerate(shifts)]
    default = sync_batch(jobs)
    written = [open(j[2]).read() for j in jobs]
    meshed = sync_batch(jobs, mesh=[CPU] * 3)
    assert meshed == default
    assert [open(j[2]).read() for j in jobs] == written
    for r, shift in zip(meshed, shifts):
        assert r["sync_was_successful"]
        assert r["offset_seconds"] == pytest.approx(shift, abs=0.02)
