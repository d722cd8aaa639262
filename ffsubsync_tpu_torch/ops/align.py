# -*- coding: utf-8 -*-
"""FFT alignment search: the host path and the device path in PyTorch
(counterpart of ``ffsubsync_tpu/ops/align.py``).

Offset conventions, the ``(-max, max]`` window, the descending-offset
tie-break and the exact rescore are the reference's. The host half below
(``Alignment`` through ``_ref_length``) is a verbatim copy of the JAX
package's host code; :func:`_score_on_mesh` and the device branch of
:func:`align_signal_pair` send the device half to
:mod:`ffsubsync_tpu_torch.ops.align_device`.
"""
import logging
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ffsubsync_tpu_torch.subs.raster import RasterSpec
from ffsubsync_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


class FailedToFindAlignmentException(Exception):
    pass


def next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, n))))


@dataclass
class Alignment:
    """Result of scoring one candidate: best (score, offset_samples)."""

    score: float
    offset: int


def _offset_window(
    n: int, n_sub: int, max_offset_samples: Optional[int]
) -> Tuple[int, int]:
    """(largest allowed offset, count) for one candidate.

    The representable offsets of an n-point circular correlation with an
    n_sub-long candidate are ``[-n_sub, n - 1 - n_sub]``; masking intersects
    that with ``(-max, max]``.
    """
    if max_offset_samples is None:
        hi = n - 1 - n_sub
        lo = -n_sub
    else:
        hi = min(max_offset_samples, n - 1 - n_sub)
        lo = max(-max_offset_samples + 1, -n_sub)
    return hi, hi - lo + 1


def search_window(
    n: int, n_sub: int, max_offset_samples: Optional[int]
) -> Tuple[int, int, int]:
    """``(hi, cnt, n_offsets)`` of one candidate's search: its largest
    allowed offset and their count (:func:`_offset_window`), and the
    static number of offsets the device search gathers, ``n`` or
    ``2 * max_offset_samples``, at least 1."""
    hi, cnt = _offset_window(n, n_sub, max_offset_samples)
    n_offsets = n if max_offset_samples is None else min(2 * int(max_offset_samples), n)
    return hi, cnt, max(1, n_offsets)


RefLike = Union[RasterSpec, np.ndarray]


def _resolve_host_align(prefer_host: bool) -> bool:
    """Whether to score candidates on the host instead of the device.

    ``FFS_TPU_HOST_ALIGN=1``/``0`` force the choice; otherwise the caller's
    preference stands. The host path exists because the alignment problem is
    host-sized whenever no audio pipeline is running: a movie-length 100 Hz
    signal is ~0.5M samples, a few rfft calls in numpy. Initializing a device
    session just for that costs orders of magnitude more than the math —
    especially on remote-attached TPU frontends — and it is exactly what the
    reference itself does on the host (ffsubsync/aligners.py:70-74).
    """
    env = os.environ.get("FFS_TPU_HOST_ALIGN")
    if env == "1":
        return True
    if env == "0":
        return False
    return prefer_host


def _host_pm(signal_or_spec: RefLike, n: int) -> np.ndarray:
    """±1-map a reference or candidate onto an FFT buffer of length *n*."""
    pm = np.zeros(n, np.float64)
    if isinstance(signal_or_spec, RasterSpec):
        raw = signal_or_spec.materialize()
    else:
        raw = np.asarray(signal_or_spec, np.float64)
    pm[: len(raw)] = 2.0 * raw - 1.0
    return pm


def _align_candidates_host(
    ref: RefLike,
    candidates: Sequence[RasterSpec],
    max_offset_samples: Optional[int],
    n: int,
) -> List["Alignment"]:
    """Numpy mirror of the device kernel — same contract surface.

    Candidates are scored one at a time (a [K, n] float64 batch would cost
    ~100 MB of host RAM for nothing; K is single-digit). Offsets are gathered
    in descending order so ``np.argmax``'s first-maximum tie-break matches the
    device kernel and the reference (aligners.py:41-48).

    Precision note: the host FFT runs in float64 (numpy's native width — and
    the width the reference itself correlates at) while the device kernel
    uses float32; the reported *score* is an exact dot product on both
    paths, so only the argmax over the raw correlation can see rounding.
    On a mathematically exact tie this path resolves by the descending-
    offset ordering (pinned by tests/test_alignment.py::
    test_exact_tie_breaks_same_on_both_paths); the device kernel's pick
    among exactly-tied offsets is float32-FFT-rounding-determined — real
    audio correlations never tie exactly, and cross-candidate selection is
    protected by the exact rescore either way.
    """
    ref_pm = _host_pm(ref, n)
    ref_f = np.fft.rfft(ref_pm)
    out: List[Alignment] = []
    for cand in candidates:
        sub_pm = _host_pm(cand, n)
        c2 = np.fft.irfft(np.conj(np.fft.rfft(sub_pm)) * ref_f, n=n)
        hi, cnt = _offset_window(n, cand.n_samples, max_offset_samples)
        # cnt can be 0 (max_offset_seconds=0): the device kernel degrades to
        # scoring the single masked offset `hi` — mirror that exactly
        offs = hi - np.arange(max(cnt, 1))
        best_off = int(offs[int(np.argmax(c2[np.mod(offs, n)]))])
        score = float(np.dot(sub_pm, np.roll(ref_pm, -best_off)))
        out.append(Alignment(score, best_off))
    return out


def _ref_length(ref: RefLike) -> int:
    if isinstance(ref, RasterSpec):
        return ref.n_samples
    return int(len(ref))


def prepare_ref_pm(ref: RefLike, n: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """Build the device-resident ±1 reference signal of FFT length *n*, on
    ``device`` (default: :func:`~ffsubsync_tpu_torch.device.get_device`)."""
    from ffsubsync_tpu_torch.device import get_device
    from ffsubsync_tpu_torch.ops import align_device

    return align_device.prepare_ref_pm(ref, n, device or get_device())


@tracing.spanned("align")
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
    if _resolve_host_align(prefer_host):
        n = next_pow2(n_ref + max(c.n_samples for c in candidates))
        return _align_candidates_host(ref, candidates, max_offset_samples, n)
    if hasattr(ref, "padded_values") and ref.device is not None:
        device = ref.device  # labels already on their device
    if device is None:
        raise ValueError("align_candidates: no device for the device path")
    return _score_on_mesh([ref], [candidates], max_offset_samples, (device,))[0]


def _score_on_mesh(
    refs: Sequence,
    candidates_per_ref: Sequence[Sequence[RasterSpec]],
    max_offset_samples: Optional[int],
    mesh: Sequence[torch.device],
) -> List[List[Alignment]]:
    """The device search of every reference's candidate set, behind its two
    traced entries: :func:`align_candidates` (one reference, on its device)
    and ``parallel.batch.BatchAligner.align_batch`` (a batch over a mesh).

    Shapes are padded batch-wide, as in the reference, so a job's result
    does not depend on the mesh. Each contiguous group of references
    (:func:`~ffsubsync_tpu_torch.device.mesh_groups`) is one
    :func:`~ffsubsync_tpu_torch.ops.align_device.align_specs` call on its
    device, and every group is launched before any result is read, so
    distinct GPUs score theirs at the same time. A lazy reference is padded
    on its own device, so no label crosses to the host, then moved to its
    group's; a host reference is copied there once."""
    from ffsubsync_tpu_torch.device import mesh_groups
    from ffsubsync_tpu_torch.ops import align_device

    max_sub = max(spec.n_samples for cands in candidates_per_ref for spec in cands)
    n = next_pow2(max(_ref_length(r) for r in refs) + max_sub)
    *arrays, n_offsets = pack_candidates(candidates_per_ref, n, max_offset_samples)
    launched = []
    for _slot, dev, part in mesh_groups(len(refs), mesh):
        ref_pm = torch.stack([align_device.prepare_ref_pm(r, n, dev).to(dev) for r in refs[part]])
        launched.append(align_device.align_specs(
            ref_pm, *(torch.from_numpy(a[part]).to(dev) for a in arrays), n, n_offsets
        ))
    with tracing.span("label_wait"):
        scores = np.concatenate([s.cpu().numpy() for s, _o in launched])
        offsets = np.concatenate([o.cpu().numpy() for _s, o in launched])
    return [
        [Alignment(float(scores[i, j]), int(offsets[i, j])) for j in range(len(cands))]
        for i, cands in enumerate(candidates_per_ref)
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
            start_offs[i, j], cnts[i, j], _ = search_window(n, spec.n_samples, max_offset_samples)
    n_offsets = search_window(n, 1, max_offset_samples)[2]
    return starts, ends, weights, n_samples, start_offs, cnts, n_offsets


def align_signal_pair(
    refstring: Union[str, np.ndarray, Sequence[float]],
    substring: Union[str, np.ndarray, Sequence[float]],
    max_offset_samples: Optional[int] = None,
) -> Alignment:
    """Align two raw 0/1 signals (string or array form) — library parity shim.

    Accepts "10110"-style bitstrings like the reference's ``FFTAligner.fit``
    (aligners.py:51-54). The search runs on the device that
    :func:`~ffsubsync_tpu_torch.device.get_device` names (the card, or the
    CPU under ``FFS_TORCH_DEVICE=cpu``); ``FFS_TPU_HOST_ALIGN=1`` runs it in
    numpy on the host instead, as the JAX package does by default.
    """
    def _to_array(s):
        if isinstance(s, str):
            return np.array([int(ch) for ch in s], dtype=np.float64)
        return np.asarray(s, dtype=np.float64)

    ref = _to_array(refstring)
    sub = _to_array(substring)
    if len(ref) == 0 or len(sub) == 0:
        raise FailedToFindAlignmentException(
            "cannot align empty speech data "
            "(reference length=%d, subtitle length=%d); "
            "the reference or subtitles may contain no detectable speech"
            % (len(ref), len(sub))
        )
    n = next_pow2(len(ref) + len(sub))
    hi, cnt, n_offsets = search_window(n, len(sub), max_offset_samples)
    if _resolve_host_align(False):
        ref_pm = _host_pm(ref, n)
        sub_pm = _host_pm(sub, n)
        c2 = np.fft.irfft(
            np.conj(np.fft.rfft(sub_pm)) * np.fft.rfft(ref_pm), n=n
        )
        offs = hi - np.arange(max(cnt, 1))
        best_off = int(offs[int(np.argmax(c2[np.mod(offs, n)]))])
        score = float(np.dot(sub_pm, np.roll(ref_pm, -best_off)))
        return Alignment(score, best_off)
    from ffsubsync_tpu_torch.device import get_device
    from ffsubsync_tpu_torch.ops import align_device

    device = get_device()
    ref_pm = prepare_ref_pm(ref.astype(np.float32), n, device)
    sub_pm = prepare_ref_pm(sub.astype(np.float32), n, device)
    scores, offsets = align_device.align_signals(
        ref_pm,
        sub_pm[None, :],
        torch.tensor([hi], device=device),
        torch.tensor([cnt], device=device),
        n,
        n_offsets,
    )
    return Alignment(float(scores[0]), int(offsets[0]))
