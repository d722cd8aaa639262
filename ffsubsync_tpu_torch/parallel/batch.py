# -*- coding: utf-8 -*-
"""Batch alignment: many independent syncs in one search over a device mesh.

Counterpart of ``ffsubsync_tpu/parallel/batch.py::BatchAligner``. The mesh
is a sequence of ``torch.device``s (:func:`~ffsubsync_tpu_torch.device.
local_mesh`). The batch is split into one contiguous group per device, and
each group is one call of :func:`~ffsubsync_tpu_torch.ops.align_device.
align_specs` on its device, the group a stacked leading dimension. The
groups are launched before any result is read, so distinct GPUs score
theirs at the same time. Shapes are padded to batch-wide maxima, as in the
reference, so a job's result does not depend on the mesh.
"""
from typing import List, Optional, Sequence

import numpy as np
import torch

from ffsubsync_tpu_torch.ops.align import Alignment, next_pow2
from ffsubsync_tpu_torch.subs.raster import RasterSpec
from ffsubsync_tpu_torch.device import get_device, local_mesh
from ffsubsync_tpu_torch.ops.align import pack_candidates
from ffsubsync_tpu_torch.ops.align_device import align_specs, prepare_ref_pm


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
        scores = np.concatenate([s.cpu().numpy() for s, _o in launched])
        offsets = np.concatenate([o.cpu().numpy() for _s, o in launched])
        return [
            [Alignment(float(scores[i, j]), int(offsets[i, j])) for j in range(len(cands))]
            for i, cands in enumerate(candidates_per_ref)
        ]
