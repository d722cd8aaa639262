# -*- coding: utf-8 -*-
"""Audio features: analysis rate, filterbanks, host staging, the frontend.

Counterpart of ``ffsubsync_tpu/ops/features.py``. The numpy helpers are
copies (the reference module imports jax at top level); tests pin each copy
equal to the original. Two TPU-only layout rules do not carry over: frames
are staged at their true window width (the CUDA kernel reads ``[T, window]``
directly, no 128-lane padding), and the window count is not bucketed
(eager PyTorch compiles nothing per shape). Every consumer still takes an
explicit ``n_valid``, so labels of valid windows never depend on padding.
"""
import math
import os
from typing import Tuple

import numpy as np
import torch

WEBRTC_BAND_EDGES_HZ = (80.0, 250.0, 500.0, 1000.0, 2000.0, 3000.0, 4000.0)
_MIN_ANALYSIS_RATE = 12000


def frames_per_window(frame_rate: int, sample_rate: int) -> int:
    """Audio samples per 10 ms analysis window (= per output label)."""
    return frame_rate // sample_rate


def band_selector_matrix(
    n_freqs: int, frame_rate: int, window: int, edges_hz=WEBRTC_BAND_EDGES_HZ
) -> np.ndarray:
    """[n_freqs, n_bands] 0/1 matrix mapping rFFT bins to sub-bands."""
    freqs = np.fft.rfftfreq(window, d=1.0 / frame_rate)[:n_freqs]
    n_bands = len(edges_hz) - 1
    sel = np.zeros((n_freqs, n_bands), dtype=np.float32)
    for b in range(n_bands):
        lo, hi = edges_hz[b], edges_hz[b + 1]
        sel[(freqs >= lo) & (freqs < hi), b] = 1.0
    return sel


def mel_filterbank(
    n_freqs: int, frame_rate: int, n_mels: int = 40,
    fmin: float = 60.0, fmax: float = 8000.0,
) -> np.ndarray:
    """[n_freqs, n_mels] triangular mel filterbank (HTK mel scale)."""
    def hz_to_mel(f):
        return 2595.0 * math.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    fmax = min(fmax, frame_rate / 2.0)
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = np.array([mel_to_hz(m) for m in mels])
    freqs = np.linspace(0.0, frame_rate / 2.0, n_freqs)
    fb = np.zeros((n_freqs, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, mid, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        rising = (freqs - lo) / max(mid - lo, 1e-6)
        falling = (hi - freqs) / max(hi - mid, 1e-6)
        fb[:, m] = np.clip(np.minimum(rising, falling), 0.0, 1.0)
    return fb


def analysis_rate(frame_rate: int, sample_rate: int) -> int:
    """The audio rate VAD features are computed at: half-band decimate by 2
    (repeatedly) down to >= 12 kHz while the 100 Hz window stays whole.
    ``FFS_TPU_ANALYSIS_DECIMATE=0`` disables it (reference semantics)."""
    if os.environ.get("FFS_TPU_ANALYSIS_DECIMATE", "1") == "0":
        return frame_rate
    rate = frame_rate
    while rate // 2 >= _MIN_ANALYSIS_RATE and (rate // 2) % sample_rate == 0:
        rate //= 2
    return rate


def prepare_staged_input(
    pcm_i16: np.ndarray, frame_rate: int, sample_rate: int
) -> Tuple[np.ndarray, int, int, int]:
    """Host staging for the frontend: decimate to the analysis rate,
    wire-encode (``FFS_TPU_WIRE``: ``mulaw`` default, ``mulaw6``, ``i16``)
    and frame, one native pass where the host library is built.

    Returns ``(framed [n_windows, width] np, analysis_rate, window,
    n_windows)``; the last window is zero-padded (wire silence).
    """
    from ffsubsync_tpu_torch import native

    pcm = np.asarray(pcm_i16)
    rate = analysis_rate(frame_rate, sample_rate)
    decim_stages = 0
    while frame_rate > rate:
        decim_stages += 1
        frame_rate //= 2
    window = frames_per_window(frame_rate, sample_rate)
    n_dec = len(pcm)
    for _ in range(decim_stages):
        n_dec = (n_dec + 1) // 2
    n_windows = max(1, int(np.ceil(n_dec / float(window))))
    wire = os.environ.get("FFS_TPU_WIRE", "mulaw")
    if wire == "mulaw6" and window % 4 == 0:
        framed = native.stage_for_device_p6(pcm, decim_stages, window, n_windows)
    elif wire in ("mulaw", "mulaw6"):
        framed = native.stage_for_device(pcm, decim_stages, window, window, n_windows)
    else:
        for _ in range(decim_stages):
            pcm = native.decimate2(pcm)
        framed = native.frame_for_device(pcm, window, window, n_windows, mulaw=False)
    return framed, frame_rate, window, n_windows


def compute_frontend(
    pcm_i16: np.ndarray, frame_rate: int, sample_rate: int,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Full-signal frontend over one PCM buffer (any length).

    Returns ``(logmel [T,40], bands [T,6], total_power [T], n_windows)`` on
    ``device`` with ``T == n_windows``; ``total`` is in raw int16² scale.
    """
    from ffsubsync_tpu_torch.ops.frontend import fused_frontend

    framed, rate, window, n_windows = prepare_staged_input(
        pcm_i16, frame_rate, sample_rate
    )
    logmel, bands, total = fused_frontend(
        torch.from_numpy(framed).to(device), window, rate
    )
    return logmel, bands, total, n_windows


def log_mel_features(
    pcm_i16, frame_rate: int, sample_rate: int, device: torch.device
) -> torch.Tensor:
    """Log-mel features [B, n_windows, 40] of a batch of int16 clips
    [B, N] at their own rate, ``n_windows = N // window``: the trainer's
    feature pass (``ffsubsync_tpu`` ``log_mel_features``). No decimation
    and no µ-law: the clips go to :func:`~ffsubsync_tpu_torch.ops.frontend.
    fused_frontend` framed as int16 ``[B·n_windows, window]``, one kernel
    launch on a CUDA ``device``. Features are data, not parameters: no
    gradient flows through them."""
    from ffsubsync_tpu_torch.ops.frontend import fused_frontend

    pcm = torch.as_tensor(pcm_i16)
    if pcm.dtype != torch.int16 or pcm.dim() != 2:
        raise ValueError("log_mel_features wants int16 clips [B, N], got %s %r"
                         % (pcm.dtype, tuple(pcm.shape)))
    window = frames_per_window(frame_rate, sample_rate)
    b, n_windows = pcm.shape[0], pcm.shape[1] // window
    framed = pcm[:, : n_windows * window].reshape(b * n_windows, window)
    with torch.no_grad():
        logmel, _bands, _total = fused_frontend(
            framed.to(device).contiguous(), window, frame_rate
        )
    return logmel.view(b, n_windows, -1)
