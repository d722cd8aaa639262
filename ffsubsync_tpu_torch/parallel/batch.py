# -*- coding: utf-8 -*-
"""Batch alignment: many independent syncs in one search on one GPU.

Counterpart of ``ffsubsync_tpu/parallel/batch.py::BatchAligner``. The JAX
package shards the batch over a device mesh; here the batch is a stacked
leading dimension of one device's tensors, scored by one call of
:func:`~ffsubsync_tpu_torch.ops.align_device.align_specs`. Shapes are padded
to batch-wide maxima, as in the reference.
"""
from typing import List, Optional, Sequence

import torch

from ffsubsync_tpu.ops.align import Alignment, next_pow2
from ffsubsync_tpu.subs.raster import RasterSpec
from ffsubsync_tpu_torch.ops.align import pack_candidates
from ffsubsync_tpu_torch.ops.align_device import align_specs, prepare_ref_pm


class BatchAligner:
    """Scores batches of (reference, candidates) pairs on one ``device``."""

    def __init__(self, device: torch.device) -> None:
        self.device = device

    def align_batch(
        self,
        refs: Sequence,
        candidates_per_ref: Sequence[Sequence[RasterSpec]],
        max_offset_samples: Optional[int] = None,
    ) -> List[List[Alignment]]:
        """One search scoring every reference's candidate set.

        ``refs`` are speech signals: host arrays, or
        :class:`~ffsubsync_tpu_torch.ops.vad.LazySpeechSignal`s, which are
        padded on their device so no label crosses to the host. Host refs
        are copied to the device once each.
        """
        if len(refs) != len(candidates_per_ref):
            raise ValueError(
                "%d references for %d candidate sets" % (len(refs), len(candidates_per_ref))
            )
        max_sub = max(spec.n_samples for cands in candidates_per_ref for spec in cands)
        n = next_pow2(max(len(r) for r in refs) + max_sub)
        *arrays, n_offsets = pack_candidates(candidates_per_ref, n, max_offset_samples)
        ref_pm = torch.stack([prepare_ref_pm(r, n, self.device).to(self.device) for r in refs])
        scores, offsets = align_specs(
            ref_pm, *(torch.from_numpy(a).to(self.device) for a in arrays), n, n_offsets
        )
        scores = scores.cpu().numpy()
        offsets = offsets.cpu().numpy()
        return [
            [Alignment(float(scores[i, j]), int(offsets[i, j])) for j in range(len(cands))]
            for i, cands in enumerate(candidates_per_ref)
        ]
