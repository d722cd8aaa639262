# -*- coding: utf-8 -*-
"""Device half of the FFT alignment search, in PyTorch.

Counterpart of ``ffsubsync_tpu/ops/align_device.py``: rasterize every
candidate's cue intervals on the device (or take ±1 signals already built,
:func:`align_signals`), score all candidates with one batched real-FFT
cross-correlation, pick each one's best allowed offset (first maximum over
*descending* offsets, the reference's tie-break) and re-score that offset
with an exact dot product.
"""
import numpy as np
import torch

from ffsubsync_tpu_torch.subs.raster import RasterSpec


def _pm_raster(starts, ends, weights, n_samples, n: int) -> torch.Tensor:
    """Cue intervals ``[K, C]`` -> ±1-mapped signals ``[K, n]`` float32.

    Padding cues are (0, 0) intervals whose +1/-1 contributions cancel.
    Values: ``2·w - 1`` on covered samples, ``-1`` on uncovered samples
    inside the signal's true length, ``0`` beyond it (the FFT zero pad).
    """
    k = starts.shape[0]
    dev = starts.device
    row = torch.arange(k, device=dev)[:, None] * (n + 1)
    diff = torch.zeros(k * (n + 1), dtype=torch.int32, device=dev)
    ones = torch.ones(starts.numel(), dtype=torch.int32, device=dev)
    diff.index_add_(0, (row + starts).reshape(-1), ones)
    diff.index_add_(0, (row + ends).reshape(-1), -ones)
    count = torch.cumsum(diff.reshape(k, n + 1), dim=1)[:, :n]
    raw = torch.where(count > 0, weights[:, None], 0.0)
    t = torch.arange(n, device=dev)[None, :]
    return torch.where(t < n_samples[:, None], 2.0 * raw - 1.0, 0.0)


def align_specs(ref_pm, starts, ends, weights, n_samples, start_offs, cnts,
                n: int, n_offsets: int):
    """Batched rasterize + FFT cross-correlate + masked argmax + exact
    rescore of ``B`` references, each against its own ``K`` candidates
    (``ffsubsync_tpu/ops/align_device.py::_align_specs_kernel`` and its
    vmapped twin ``ffsubsync_tpu/parallel/batch.py::_batched_sync_kernel``).
    The single-file search calls it with ``B = 1``.

    Args:
      ref_pm: f32[B, n] ±1-mapped references (zeros beyond true lengths).
      starts, ends: int64[B, K, C] candidate cue intervals (padded with (0, 0)).
      weights: f32[B, K] per-candidate written value ``min(1/ratio, 1)``.
      n_samples: int64[B, K] per-candidate true signal length.
      start_offs: int64[B, K] largest allowed offset per candidate.
      cnts: int64[B, K] number of allowed offsets (descending from start_offs).
    Returns:
      (scores f32[B, K], offsets int64[B, K]) on the device.
    """
    b, k, c = starts.shape
    subs_pm = _pm_raster(
        starts.reshape(b * k, c), ends.reshape(b * k, c), weights.reshape(-1),
        n_samples.reshape(-1), n,
    ).reshape(b, k, n)
    return _search(ref_pm, subs_pm, start_offs, cnts, n, n_offsets)


def align_signals(ref_pm, subs_pm, start_offs, cnts, n: int, n_offsets: int):
    """FFT cross-correlate + masked argmax + exact rescore of ``K``
    already ±1-mapped signals against one reference
    (``ffsubsync_tpu/ops/align_device.py::_align_signals_kernel``).

    Args:
      ref_pm: f32[n] ±1-mapped reference (zeros beyond its true length).
      subs_pm: f32[K, n] ±1-mapped candidates (zeros beyond their lengths).
      start_offs: int64[K] largest allowed offset per candidate.
      cnts: int64[K] number of allowed offsets (descending from start_offs).
    Returns:
      (scores f32[K], offsets int64[K]) on the device.
    """
    scores, offsets = _search(ref_pm[None], subs_pm[None], start_offs[None], cnts[None],
                              n, n_offsets)
    return scores[0], offsets[0]


def _search(ref_pm, subs_pm, start_offs, cnts, n: int, n_offsets: int):
    """The search shared by :func:`align_specs` and :func:`align_signals`
    over references ``[B, n]`` and their candidates ``[B, K, n]``."""
    k = subs_pm.shape[1]
    ref_f = torch.fft.rfft(ref_pm, dim=-1)
    sub_f = torch.fft.rfft(subs_pm, dim=-1)
    # c2[b, k, m] = sum_s subs_pm[b, k, s] * ref_pm[b, (s + m) mod n]
    c2 = torch.fft.irfft(torch.conj(sub_f) * ref_f[:, None, :], n=n, dim=-1)
    j = torch.arange(n_offsets, device=ref_pm.device)
    offs = start_offs[..., None] - j
    gathered = torch.gather(c2, 2, torch.remainder(offs, n))
    gathered = torch.where(j < cnts[..., None], gathered, float("-inf"))
    best_j = torch.argmax(gathered, dim=-1)  # first maximum
    best_off = torch.gather(offs, 2, best_j[..., None])[..., 0]
    # exact rescore at the chosen offset: the roll of each reference as a
    # gather, one candidate at a time (an index of [B, n], not [B, K, n]),
    # with no host round trip for the offsets
    t = torch.arange(n, device=ref_pm.device)
    scores = torch.stack(
        [
            torch.sum(
                subs_pm[:, i]
                * torch.gather(ref_pm, 1, torch.remainder(t + best_off[:, i, None], n)),
                dim=-1,
            )
            for i in range(k)
        ],
        dim=1,
    )
    return scores, best_off


def _pm_from_signal(values, length: int, n: int) -> torch.Tensor:
    """±1-map a materialized signal of true length ``length`` (f32 [n])."""
    t = torch.arange(n, device=values.device)
    return torch.where(t < length, 2.0 * values.to(torch.float32) - 1.0, 0.0)


def prepare_ref_pm(ref, n: int, device: torch.device) -> torch.Tensor:
    """The ±1 reference signal of FFT length *n* on the device."""
    if hasattr(ref, "padded_values"):  # LazySpeechSignal: already there
        return _pm_from_signal(ref.padded_values(n), len(ref), n)
    if isinstance(ref, RasterSpec):
        c = max(1, len(ref.starts))
        starts = np.zeros((1, c), np.int64)
        ends = np.zeros((1, c), np.int64)
        starts[0, : len(ref.starts)] = ref.starts
        ends[0, : len(ref.ends)] = ref.ends
        return _pm_raster(
            torch.from_numpy(starts).to(device),
            torch.from_numpy(ends).to(device),
            torch.tensor([ref.weight], dtype=torch.float32, device=device),
            torch.tensor([ref.n_samples], device=device),
            n,
        )[0]
    values = np.zeros(n, np.float32)
    values[: len(ref)] = ref
    return _pm_from_signal(torch.from_numpy(values).to(device), len(ref), n)
