# -*- coding: utf-8 -*-
"""Fused audio frontend: the CUDA kernel, its plain PyTorch version, the wire.

Counterpart of ``ffsubsync_tpu/ops/pallas/frontend.py``. One pass over
framed PCM emits everything every VAD backend reads, per 10 ms window:

- log-mel features (neural VAD input): Hann window → rFFT → power → mel
  filterbank → ``log(x + 1e-6)``;
- webrtc-class sub-band powers: rFFT (no window) → power → 6-band selector;
- total window power (raw int16² scale).

:func:`fused_frontend` launches the hand-written Hopper kernel
(``csrc/frontend.cu``) for a CUDA tensor and runs :func:`frontend_plain`
for a CPU tensor. There is no fallback between the two: a CUDA tensor gets
the kernel or an exception.

Wire formats (the host→device encoding of the framed PCM), told apart by
dtype and row width: int16 samples ``[T, window]``; µ-law int8 codes
``[T, window]``; packed 6-bit µ-law ``[T, window*3//4]`` (4 biased codes
per 3 bytes, silence = code 31).
"""
import functools
import math
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ffsubsync_tpu_torch.ops.features import band_selector_matrix, mel_filterbank

N_MELS = 40
N_BANDS = 6
LOG_MEL_EPS = 1e-6

MULAW_MU = 255.0
_MULAW_SCALE = 32768.0 / MULAW_MU
MULAW6_LEVELS = 31.0

WIRE_I16, WIRE_MULAW, WIRE_MULAW6 = 0, 1, 2  # csrc/frontend.cu's enum Wire

# segment and decode threads launch concurrently; += alone can lose counts
_LAUNCHES_LOCK = threading.Lock()


def mulaw_encode_host(pcm_i16: np.ndarray) -> np.ndarray:
    """Vectorized host-side µ-law encode int16 → int8 in [-127, 127]."""
    x = pcm_i16.astype(np.float32) / 32768.0
    y = np.sign(x) * np.log1p(MULAW_MU * np.abs(x)) / np.log1p(MULAW_MU)
    return np.round(y * 127.0).astype(np.int8)


def mulaw_decode(code: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`mulaw_encode_host` → float32 int16-scale."""
    c = code.to(torch.float32)
    mag = torch.abs(c) * (1.0 / 127.0)
    return torch.sign(c) * _MULAW_SCALE * (torch.exp2(mag * 8.0) - 1.0)


def packed6_width(window: int) -> int:
    """Wire row bytes for a packed 6-bit window (4 codes → 3 bytes)."""
    if window % 4 != 0:
        raise ValueError("mulaw6 wire needs window %% 4 == 0, got %d" % window)
    return window * 3 // 4


def unpack_mulaw6(packed: torch.Tensor, window: int) -> torch.Tensor:
    """[T, window*3//4] packed int8 → float32 PCM [T, window]."""
    t = packed.shape[0]
    b = packed.view(torch.uint8).to(torch.int32).reshape(t, window // 4, 3)
    u = torch.stack(
        [
            b[..., 0] >> 2,
            ((b[..., 0] & 3) << 4) | (b[..., 1] >> 4),
            ((b[..., 1] & 15) << 2) | (b[..., 2] >> 6),
            b[..., 2] & 63,
        ],
        dim=-1,
    ).reshape(t, window)
    c = (u - 31).to(torch.float32)
    mag = torch.abs(c) * (1.0 / MULAW6_LEVELS)
    return torch.sign(c) * _MULAW_SCALE * (torch.exp2(mag * 8.0) - 1.0)


def wire_kind(framed: torch.Tensor, window: int) -> int:
    """Which wire a framed tensor carries (raises on anything else)."""
    if framed.dim() != 2:
        raise ValueError("framed PCM must be 2-D, got shape %r" % (tuple(framed.shape),))
    width = framed.shape[1]
    if width == window and framed.dtype == torch.int16:
        return WIRE_I16
    if width == window and framed.dtype == torch.int8:
        return WIRE_MULAW
    if framed.dtype == torch.int8 and window % 4 == 0 and width == window * 3 // 4:
        return WIRE_MULAW6
    raise ValueError(
        "framed PCM %s of width %d is no wire for window %d (int16 or int8 "
        "[T, %d], or packed int8 [T, %d])"
        % (framed.dtype, width, window, window, window * 3 // 4)
    )


def wire_to_frame(framed: torch.Tensor, window: int) -> torch.Tensor:
    """Decode any wire to float32 int16-scale samples ``[T, window]``."""
    kind = wire_kind(framed, window)
    if kind == WIRE_I16:
        return framed.to(torch.float32)
    if kind == WIRE_MULAW:
        return mulaw_decode(framed)
    return unpack_mulaw6(framed, window)


def wire_silence_rows(framed_np, n_rows: int, window: int):
    """Host-side rows of wire-format silence matching ``framed_np``'s layout.
    Zero bytes are silence on every wire EXCEPT packed 6-bit, whose silence
    is the packed biased-31 pattern."""
    if (
        framed_np.dtype == np.int8
        and window % 4 == 0
        and framed_np.shape[1] == window * 3 // 4
    ):
        pattern = np.array([125, 247, 223], np.uint8).view(np.int8)
        return np.tile(pattern, (n_rows, framed_np.shape[1] // 3))
    return np.zeros((n_rows,) + framed_np.shape[1:], framed_np.dtype)


@functools.lru_cache(maxsize=32)
def _plain_mats(frame_rate: int, window: int, device: torch.device):
    n_freqs = window // 2 + 1
    mel_fb = torch.from_numpy(mel_filterbank(n_freqs, frame_rate, N_MELS))
    band_sel = torch.from_numpy(band_selector_matrix(n_freqs, frame_rate, window))
    return mel_fb.to(device), band_sel.to(device)


def frontend_plain(
    framed: torch.Tensor, window: int, frame_rate: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch frontend; mirrors ``ffsubsync_tpu/ops/features.py::
    _frontend_jnp`` with ``torch.fft.rfft``. Returns ``(logmel [T, 40],
    bands [T, 6], total [T])`` float32 on ``framed``'s device."""
    raw = wire_to_frame(framed, window)
    mel_fb, band_sel = _plain_mats(frame_rate, window, framed.device)
    norm = raw / 32768.0
    hann = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi
        * torch.arange(window, dtype=torch.float32, device=framed.device)
        / window
    )
    spec_m = torch.fft.rfft(norm * hann[None, :], dim=-1)
    p_mel = spec_m.real ** 2 + spec_m.imag ** 2
    logmel = torch.log(p_mel @ mel_fb + LOG_MEL_EPS)
    spec_p = torch.fft.rfft(norm, dim=-1)
    p_pl = spec_p.real ** 2 + spec_p.imag ** 2
    bands = p_pl @ band_sel
    total = torch.mean(raw * raw, dim=-1)
    return logmel, bands, total


def _column_runs(mat: np.ndarray, what: str) -> Tuple[list, list]:
    """(first rows, ends) of each column's nonzero entries, which must be
    one contiguous run of rfft bins; (0, 0) for an empty column."""
    lo, hi = [], []
    for j in range(mat.shape[1]):
        idx = np.nonzero(mat[:, j])[0]
        if len(idx) and idx[-1] - idx[0] + 1 != len(idx):
            raise ValueError("%s %d is not a contiguous bin range" % (what, j))
        lo.append(int(idx[0]) if len(idx) else 0)
        hi.append(int(idx[-1]) + 1 if len(idx) else 0)
    return lo, hi


def _band_ranges(frame_rate: int, window: int) -> Tuple[int, ...]:
    """The band selector as (6 first bins, 6 end bins): the kernel sums
    index ranges."""
    lo, hi = _column_runs(band_selector_matrix(window // 2 + 1, frame_rate, window), "band")
    return tuple(lo + hi)


# csrc/frontend.cu's struct Tables, the layout of the buffer kernel_tables
# builds: mel lo, hi and offset (40 each), band lo and hi (6 each), then
# kMaxMelWeights float weights
_TABLES_BYTES = (3 * N_MELS + 2 * N_BANDS + 512) * 4


class KernelConfig(NamedTuple):
    rows: int  # windows per tile
    warp_cols: int  # basis columns per warp and pass
    n_cols: int  # the cos | sin basis width, 2 * n_freqs padded
    resident: bool  # the basis stays in shared memory
    smem: int  # bytes of shared memory per block


def _check(lib, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError("frontend kernel %s failed: %s (cudaError %d)"
                           % (what, lib.ffs_cuda_error_string(status).decode(), status))


def kernel_config(window: int, wire: int) -> KernelConfig:
    """The tile shape the kernel takes for ``window`` and ``wire`` on the
    current CUDA device (``csrc/frontend.cu``'s ``choose_config``: the
    first shape that fits one block's shared memory, with the basis
    resident if any fits so). Builds the library if it is not built yet."""
    import ctypes

    from ffsubsync_tpu_torch.ops import _build

    lib = _build.load_library()
    out = (ctypes.c_int * 5)()
    _check(lib, lib.ffs_frontend_config(window, wire, out), "config")
    return KernelConfig(out[0], out[1], out[2], bool(out[3]), out[4])


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round to TF32 (10 mantissa bits, ties away from zero, as
    ``cvt.rna.tf32.f32``), kept in float32."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def dft_basis(window: int, n_cols: int) -> np.ndarray:
    """float64 ``[kp, n_cols]``: cos | sin of ``2 pi t k / window`` over
    ``/32768`` for ``k < n_freqs`` (``kp`` = window rounded up to 8), zero
    padding elsewhere. ``frames @ basis`` gives ``[C | S]``, ``X = C - iS``."""
    n_freqs = window // 2 + 1
    kp = -(-window // 8) * 8
    t = np.arange(window)[:, None]
    ang = 2.0 * np.pi * ((t * np.arange(n_freqs)[None, :]) % window) / window
    basis = np.zeros((kp, n_cols))
    basis[:window, :n_freqs] = np.cos(ang) / 32768.0
    basis[:window, n_freqs: 2 * n_freqs] = np.sin(ang) / 32768.0
    return basis


def split_basis(window: int, n_cols: int) -> np.ndarray:
    """The basis as the kernel reads it: float32 ``[kp/8, n_cols/8, 32, 4]``
    in mma B-fragment order, lane ``(g, tig)`` of k-step ``ks`` and column
    tile ``nt`` holding rows ``8ks + 2tig`` and ``8ks + 2tig + 1`` of
    column ``8nt + g`` (the samples the kernel puts in fragment columns
    ``tig`` and ``tig + 4``: adjacent, so one load fetches both), each as
    (hi, hi, lo, lo) with ``hi = tf32(b)`` and ``lo = tf32(b - hi)``."""
    basis = dft_basis(window, n_cols)
    hi = _tf32(basis)
    lo = _tf32(basis - hi)
    lane = np.arange(32)
    k = np.arange(basis.shape[0] // 8)[:, None, None] * 8 + 2 * (lane % 4)[None, None, :]
    n = np.arange(n_cols // 8)[None, :, None] * 8 + (lane // 4)[None, None, :]
    return np.stack([hi[k, n], hi[k + 1, n], lo[k, n], lo[k + 1, n]], axis=-1)


def mel_ranges(frame_rate: int, window: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mel filterbank as contiguous nonzero bin runs: (first bins [40],
    ends [40], weights of every run back to back). The kernel sums only
    these (a triangular filter's support; at most two filters per bin)."""
    fb = mel_filterbank(window // 2 + 1, frame_rate, N_MELS)
    lo, hi = _column_runs(fb, "mel filter")
    weights = [fb[a:b, m] for m, (a, b) in enumerate(zip(lo, hi))]
    return np.array(lo), np.array(hi), np.concatenate(weights).astype(np.float32)


def kernel_tables(frame_rate: int, window: int) -> np.ndarray:
    """The kernel's struct Tables as int32: each mel filter's nonzero bin
    run (first, end, offset of its weights), the band ranges, then the
    weights as float32 bits."""
    lo, hi, weights = mel_ranges(frame_rate, window)
    offsets = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    tables = np.zeros(_TABLES_BYTES // 4, np.int32)
    tables[: 3 * N_MELS] = np.concatenate([lo, hi, offsets])
    tables[3 * N_MELS: 3 * N_MELS + 2 * N_BANDS] = _band_ranges(frame_rate, window)
    tables[3 * N_MELS + 2 * N_BANDS:].view(np.float32)[: len(weights)] = weights
    return tables


class _Consts(NamedTuple):
    n_cols: int  # the basis width the kernel's configuration wants
    basis: torch.Tensor  # split_basis on the device
    tables: torch.Tensor  # kernel_tables on the device


@functools.lru_cache(maxsize=32)
def _kernel_consts(frame_rate: int, window: int, wire: int, device: torch.device) -> _Consts:
    with torch.cuda.device(device):
        n_cols = kernel_config(window, wire).n_cols
    basis = torch.from_numpy(np.ascontiguousarray(split_basis(window, n_cols)))
    tables = torch.from_numpy(kernel_tables(frame_rate, window))
    return _Consts(n_cols, basis.to(device), tables.to(device))


def fused_frontend(
    framed: torch.Tensor, window: int, frame_rate: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frontend over framed wire PCM (see the module docstring).

    A CUDA tensor launches the kernel of ``csrc/frontend.cu`` (counted in
    ``fused_frontend.launches``); a CPU tensor runs :func:`frontend_plain`.
    Returns ``(logmel [T, 40], bands [T, 6], total [T])`` float32.
    """
    if framed.device.type == "cpu":
        return frontend_plain(framed, window, frame_rate)
    if framed.device.type != "cuda":
        raise ValueError("fused_frontend: unsupported device %s" % framed.device)
    wire = wire_kind(framed, window)
    if not framed.is_contiguous():
        raise ValueError("fused_frontend: framed PCM must be contiguous")
    from ffsubsync_tpu_torch.ops import _build

    lib = _build.load_library()
    t = framed.shape[0]
    dev = framed.device
    logmel = torch.empty((t, N_MELS), dtype=torch.float32, device=dev)
    bands = torch.empty((t, N_BANDS), dtype=torch.float32, device=dev)
    total = torch.empty((t,), dtype=torch.float32, device=dev)
    if t == 0:
        return logmel, bands, total
    consts = _kernel_consts(frame_rate, window, wire, dev)
    if framed.data_ptr() % 16:
        framed = framed.clone()  # the kernel streams 16-byte chunks
    with torch.cuda.device(dev):
        status = lib.ffs_frontend_launch(
            framed.data_ptr(), wire, t, window, consts.n_cols,
            consts.basis.data_ptr(), consts.tables.data_ptr(),
            logmel.data_ptr(), bands.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check(lib, status, "launch")
    with _LAUNCHES_LOCK:
        fused_frontend.launches += 1
    return logmel, bands, total


fused_frontend.launches = 0
