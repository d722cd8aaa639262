# -*- coding: utf-8 -*-
"""FFT alignment search: the host path of the JAX package, the device path
in PyTorch (counterpart of ``ffsubsync_tpu/ops/align.py::align_candidates``).

Offset conventions, the ``(-max, max]`` window, the descending-offset
tie-break and the exact rescore are the reference's; the host path and its
helpers are imported from it unchanged.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ffsubsync_tpu.ops.align import (
    Alignment,
    FailedToFindAlignmentException,
    RefLike,
    _align_candidates_host,
    _offset_window,
    _ref_length,
    _resolve_host_align,
    next_pow2,
)
from ffsubsync_tpu.subs.raster import RasterSpec


def align_candidates(
    ref: RefLike,
    candidates: Sequence[RasterSpec],
    max_offset_samples: Optional[int] = None,
    prefer_host: bool = False,
    device: Optional[torch.device] = None,
) -> List[Alignment]:
    """Score every candidate against the reference.

    With ``prefer_host`` (or ``FFS_TPU_HOST_ALIGN=1``) the search runs in
    numpy on the host, as in the JAX package. Otherwise it runs on the
    reference signal's device (a :class:`~ffsubsync_tpu_torch.ops.vad.
    LazySpeechSignal`'s own), or on ``device``. Raises
    :class:`FailedToFindAlignmentException` when either side is empty.
    """
    from ffsubsync_tpu_torch.ops import align_device

    n_ref = _ref_length(ref)
    if n_ref == 0 or any(c.n_samples == 0 for c in candidates):
        bad = min((c.n_samples for c in candidates), default=0)
        raise FailedToFindAlignmentException(
            "cannot align empty speech data "
            "(reference length=%d, subtitle length=%d); "
            "the reference or subtitles may contain no detectable speech"
            % (n_ref, bad)
        )
    if not candidates:
        return []
    n = next_pow2(n_ref + max(c.n_samples for c in candidates))
    if _resolve_host_align(prefer_host):
        return _align_candidates_host(ref, candidates, max_offset_samples, n)
    if hasattr(ref, "padded_values") and ref.device is not None:
        device = ref.device  # labels already on their device
    if device is None:
        raise ValueError("align_candidates: no device for the device path")
    *arrays, n_offsets = pack_candidates([candidates], n, max_offset_samples)
    ref_pm = align_device.prepare_ref_pm(ref, n, device)
    scores, offsets = align_device.align_specs(
        ref_pm[None], *(torch.from_numpy(a).to(device) for a in arrays), n, n_offsets
    )
    return [
        Alignment(float(s), int(o))
        for s, o in zip(scores[0].cpu().tolist(), offsets[0].cpu().tolist())
    ]


def pack_candidates(
    candidates_per_ref: Sequence[Sequence[RasterSpec]],
    n: int,
    max_offset_samples: Optional[int],
) -> Tuple[np.ndarray, ...]:
    """The ``B`` references' candidate sets as :func:`~ffsubsync_tpu_torch.
    ops.align_device.align_specs` takes them, padded batch-wide: ``K`` is
    the largest set, ``C`` the next power of two of the most cues. Returns
    ``(starts, ends [B, K, C], weights, n_samples, start_offs, cnts [B, K],
    n_offsets)``; a padding candidate is one empty sample with one offset.
    """
    b = len(candidates_per_ref)
    k = max(len(c) for c in candidates_per_ref)
    c_pad = next_pow2(
        max(1, max(len(spec.starts) for cands in candidates_per_ref for spec in cands))
    )
    starts = np.zeros((b, k, c_pad), np.int64)
    ends = np.zeros((b, k, c_pad), np.int64)
    weights = np.zeros((b, k), np.float32)
    n_samples = np.ones((b, k), np.int64)
    start_offs = np.zeros((b, k), np.int64)
    cnts = np.ones((b, k), np.int64)
    for i, cands in enumerate(candidates_per_ref):
        for j, spec in enumerate(cands):
            starts[i, j, : len(spec.starts)] = spec.starts
            ends[i, j, : len(spec.ends)] = spec.ends
            weights[i, j] = spec.weight
            n_samples[i, j] = spec.n_samples
            start_offs[i, j], cnts[i, j] = _offset_window(n, spec.n_samples, max_offset_samples)
    n_offsets = n if max_offset_samples is None else min(2 * int(max_offset_samples), n)
    return starts, ends, weights, n_samples, start_offs, cnts, max(1, n_offsets)
