# -*- coding: utf-8 -*-
"""Data parallelism over a device mesh: the batch search and the trainer.

Counterpart of ``ffsubsync_tpu/parallel/batch.py::BatchAligner``. The mesh
is a sequence of ``torch.device``s (:func:`~ffsubsync_tpu_torch.device.
local_mesh`). The batch is split into one contiguous group per device, and
each group is one call of :func:`~ffsubsync_tpu_torch.ops.align_device.
align_specs` on its device, the group a stacked leading dimension. The
groups are launched before any result is read, so distinct GPUs score
theirs at the same time. Shapes are padded to batch-wide maxima, as in the
reference, so a job's result does not depend on the mesh.

:func:`make_vad_train_step` is the counterpart of the reference's
data-parallel training step, on the same kind of mesh (see its docstring).
"""
import copy
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from ffsubsync_tpu_torch.ops.align import Alignment, next_pow2
from ffsubsync_tpu_torch.subs.raster import RasterSpec
from ffsubsync_tpu_torch.device import get_device, local_mesh
from ffsubsync_tpu_torch.models import neural_vad
from ffsubsync_tpu_torch.ops.align import pack_candidates
from ffsubsync_tpu_torch.ops.align_device import align_specs, prepare_ref_pm
from ffsubsync_tpu_torch.ops.features import log_mel_features
from ffsubsync_tpu_torch.utils import tracing


class BatchAligner:
    """Scores batches of (reference, candidates) pairs across ``mesh``
    (default: :func:`~ffsubsync_tpu_torch.device.local_mesh` of the device
    ``FFS_TORCH_DEVICE`` names)."""

    def __init__(self, mesh: Optional[Sequence[torch.device]] = None) -> None:
        if mesh is None:
            mesh = local_mesh(get_device())
        self.mesh = tuple(torch.device(d) for d in mesh)
        if not self.mesh:
            raise ValueError("BatchAligner needs a mesh of at least one device")

    @tracing.spanned("align")
    def align_batch(
        self,
        refs: Sequence,
        candidates_per_ref: Sequence[Sequence[RasterSpec]],
        max_offset_samples: Optional[int] = None,
    ) -> List[List[Alignment]]:
        """One search scoring every reference's candidate set.

        ``refs`` are speech signals: host arrays, or
        :class:`~ffsubsync_tpu_torch.ops.vad.LazySpeechSignal`s, which are
        padded on their device so no label crosses to the host, then moved
        to their group's device. Host refs are copied to it once each.
        """
        if len(refs) != len(candidates_per_ref):
            raise ValueError(
                "%d references for %d candidate sets" % (len(refs), len(candidates_per_ref))
            )
        max_sub = max(spec.n_samples for cands in candidates_per_ref for spec in cands)
        n = next_pow2(max(len(r) for r in refs) + max_sub)
        *arrays, n_offsets = pack_candidates(candidates_per_ref, n, max_offset_samples)
        launched = []
        for dev, group in zip(self.mesh, np.array_split(np.arange(len(refs)), len(self.mesh))):
            if len(group) == 0:
                continue
            part = slice(group[0], group[-1] + 1)
            ref_pm = torch.stack([prepare_ref_pm(r, n, dev).to(dev) for r in refs[part]])
            launched.append(align_specs(
                ref_pm, *(torch.from_numpy(a[part]).to(dev) for a in arrays), n, n_offsets
            ))
        with tracing.span("label_wait"):
            scores = np.concatenate([s.cpu().numpy() for s, _o in launched])
            offsets = np.concatenate([o.cpu().numpy() for _s, o in launched])
        return [
            [Alignment(float(scores[i, j]), int(offsets[i, j])) for j in range(len(cands))]
            for i, cands in enumerate(candidates_per_ref)
        ]


def _groups(n: int, mesh: Sequence[torch.device]):
    """(slot, device, contiguous index range) of each mesh slot that gets
    some of ``n`` clips."""
    return [(i, dev, slice(g[0], g[-1] + 1))
            for i, (dev, g) in enumerate(zip(mesh, np.array_split(np.arange(n), len(mesh))))
            if len(g)]


def vad_batch_gradients(net, mesh, replicas, pcm_batch, label_batch, window,
                        sample_rate=100, weight_batch=None) -> torch.Tensor:
    """The loss of one batch, and its gradients in ``net``'s ``.grad``.

    The clips split into one contiguous group per slot of ``mesh``
    (``np.array_split``). ``net`` lives on ``mesh[0]`` and serves the first
    group; the others are computed on their own devices by ``replicas``
    (one module per further slot, made here when missing, parameters
    refreshed from ``net`` on entry). Each group's feature pass is one
    :func:`~ffsubsync_tpu_torch.ops.features.log_mel_features` call, and
    its loss is its share of the whole batch's, ``Σ_group wᵢ lossᵢ / Σ_all
    wᵢ``, so the groups' gradients, summed on ``mesh[0]``, weigh every clip
    alike however ragged the split. Returns the loss on ``mesh[0]``.
    """
    pcm = torch.as_tensor(pcm_batch)
    labels = torch.as_tensor(label_batch, dtype=torch.float32)
    weights = (torch.ones(labels.shape[0]) if weight_batch is None
               else torch.as_tensor(weight_batch, dtype=torch.float32))
    total = float(weights.sum())
    frame_rate = window * sample_rate
    net.zero_grad(set_to_none=True)
    losses, grads = [], []
    for slot, dev, part in _groups(labels.shape[0], mesh):
        if slot == 0:
            model = net
        else:
            if slot not in replicas:
                replicas[slot] = copy.deepcopy(net).to(dev)
            model = replicas[slot]
            with torch.no_grad():
                for mine, theirs in zip(model.parameters(), net.parameters()):
                    mine.copy_(theirs)
            model.zero_grad(set_to_none=True)
        feats = log_mel_features(pcm[part], frame_rate, sample_rate, dev)
        loss = neural_vad.vad_loss(model, feats, labels[part].to(dev), weights[part].to(dev), total)
        loss.backward()
        losses.append(loss.detach())
        if slot:
            grads.append([p.grad for p in model.parameters()])
    home = mesh[0]
    with torch.no_grad():
        for theirs in grads:
            for p, g in zip(net.parameters(), theirs):
                p.grad += g.to(home)
        return sum(l.to(home) for l in losses)


def adam(net: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over ``net``'s parameters with optax.adam's defaults."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_vad_train_step(mesh: Sequence[torch.device], learning_rate: float = 3e-3):
    """Data-parallel neural-VAD training step over ``mesh`` (a sequence of
    ``torch.device``s; the reference's ``make_vad_train_step``).

    One controller drives every device, as the batch search does, with no
    ``torch.distributed``: :func:`vad_batch_gradients` computes each group
    of clips on its device and sums the gradients on ``mesh[0]``, where
    Adam (optax's defaults) steps the one copy of the parameters. Returns
    ``(step_fn, init_fn)``:

    - ``init_fn(generator, frame_rate=48000, sample_rate=100)`` ->
      ``(net, optimizer, window)``, the net drawn by ``init_params``;
    - ``step_fn(net, optimizer, pcm_batch, label_batch, window,
      sample_rate=100)`` takes one step on int16 clips [B, N] and window
      labels [B, N // window] and returns the batch's mean loss.
    """
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("make_vad_train_step needs a mesh of at least one device")
    replicas_of = weakref.WeakKeyDictionary()  # net -> {slot: replica}

    def init_fn(generator, frame_rate=48000, sample_rate=100):
        net = neural_vad.NeuralVADNet()
        net.load_state_dict(neural_vad.params_from_numpy(neural_vad.init_params(generator)))
        net = net.to(mesh[0]).train()
        return net, adam(net, learning_rate), frame_rate // sample_rate

    def step_fn(net, optimizer, pcm_batch, label_batch, window, sample_rate=100):
        replicas = replicas_of.setdefault(net, {})
        loss = vad_batch_gradients(net, mesh, replicas, pcm_batch, label_batch,
                                   window, sample_rate)
        optimizer.step()
        return loss

    return step_fn, init_fn
