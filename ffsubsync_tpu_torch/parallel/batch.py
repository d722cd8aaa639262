# -*- coding: utf-8 -*-
"""Data parallelism over a device mesh: the batch search and the trainer.

Counterpart of ``ffsubsync_tpu/parallel/batch.py::BatchAligner``. The mesh
is a sequence of ``torch.device``s (:func:`~ffsubsync_tpu_torch.device.
local_mesh`), and the search over it is the single-file search's,
:func:`~ffsubsync_tpu_torch.ops.align._score_on_mesh`.

:func:`make_vad_train_step` is the counterpart of the reference's
data-parallel training step, on the same kind of mesh (see its docstring).
"""
import copy
import weakref
from typing import List, Optional, Sequence

import torch

from ffsubsync_tpu_torch.ops.align import Alignment, _score_on_mesh
from ffsubsync_tpu_torch.subs.raster import RasterSpec
from ffsubsync_tpu_torch.device import get_device, local_mesh, mesh_groups
from ffsubsync_tpu_torch.models import neural_vad
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
        """One search scoring every reference's candidate set over the
        mesh. ``refs`` are speech signals: host arrays, or
        :class:`~ffsubsync_tpu_torch.ops.vad.LazySpeechSignal`s."""
        if len(refs) != len(candidates_per_ref):
            raise ValueError(
                "%d references for %d candidate sets" % (len(refs), len(candidates_per_ref))
            )
        return _score_on_mesh(refs, candidates_per_ref, max_offset_samples, self.mesh)


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
    for slot, dev, part in mesh_groups(labels.shape[0], mesh):
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
