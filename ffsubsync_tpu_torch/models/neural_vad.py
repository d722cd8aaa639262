# -*- coding: utf-8 -*-
"""In-tree neural VAD (the "silero-class" detector) as a PyTorch module.

Counterpart of ``ffsubsync_tpu/models/neural_vad.py``, same architecture
and the same trained weights (``models/weights/*.npz``, byte-equal copies
of ``ffsubsync_tpu/models/weights/*.npz`` shipped with this package):
log-mel [T, 40] plus three engineered temporal channels
(:func:`_aux_channels`) → dense 43→96 → seven residual dilated temporal
convolutions (kernel 5, dilations 1…64) → dense 96→1 → sigmoid. The JAX
package wrote the convs as shifted matmuls for the TPU's compiler; here
they are ``nn.Conv1d`` (a SAME-padded cross-correlation is exactly what
``F.conv1d`` computes with ``padding = 2·dilation``).
"""
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The reference computes in full float32. On the card cuDNN would run the
# float32 convolutions in TF32 (about three decimal digits) by default and
# a matmul could be allowed to as well: keep both in true float32 so the
# card computes what the reference computes.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

logger = logging.getLogger(__name__)

N_MELS = 40
HIDDEN = 96
KERNEL = 5
DILATIONS = (1, 2, 4, 8, 16, 32, 64)
AUX_RADIUS = 45
# windows of left context carried across chunks: the conv stack's one-sided
# receptive field plus the aux radius, so chunked and unchunked inference
# see the same inputs
CONTEXT = 320
N_AUX = 3
WEIGHTS_FILENAME = "neural_vad_weights.npz"

assert (KERNEL // 2) * sum(DILATIONS) + AUX_RADIUS <= CONTEXT, (
    "neural VAD receptive field exceeds the carried context window"
)


def _weights_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")


def expected_param_shapes() -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> shape of the JAX layout (the shipped .npz files)."""
    shapes: Dict[str, Tuple[int, ...]] = {
        "w_in": (N_MELS + N_AUX, HIDDEN),
        "b_in": (HIDDEN,),
        "w_out": (HIDDEN, 1),
        "b_out": (1,),
    }
    for i in range(len(DILATIONS)):
        shapes["w_conv%d" % i] = (KERNEL, HIDDEN, HIDDEN)
        shapes["b_conv%d" % i] = (HIDDEN,)
    return shapes


def default_weights_path(rate: Optional[int] = None) -> str:
    """Weights file for an *analysis* rate; the rate-less legacy name is the
    48 kHz fallback."""
    if rate is not None:
        rated = os.path.join(_weights_dir(), "neural_vad_weights_%d.npz" % rate)
        if os.path.exists(rated):
            return rated
    return os.path.join(_weights_dir(), WEIGHTS_FILENAME)


def has_trained_weights(rate: int) -> bool:
    """Whether shape-compatible trained weights ship for this analysis rate
    (reads only the npz headers)."""
    path = os.path.join(_weights_dir(), "neural_vad_weights_%d.npz" % rate)
    if not os.path.exists(path):
        return False
    try:
        expected = expected_param_shapes()
        with np.load(path) as loaded:
            return all(
                k in loaded.files and loaded[k].shape == shape
                for k, shape in expected.items()
            )
    except (OSError, ValueError):
        return False


def _box_mean(
    v: torch.Tensor, vm: torch.Tensor, k: int, nonneg: bool = False
) -> torch.Tensor:
    """Centered ±k box mean of a [T] series over its valid rows only.

    ``nonneg=True`` declares the input non-negative and clamps the result at
    zero: the box sum is a difference of float32 prefix sums, and CUDA's
    ``cumsum`` is a parallel scan whose rounding is not monotone, so over a
    movie-length series ``s[hi+1] - s[lo]`` on a near-silent stretch can
    come out slightly negative — ``sqrt`` of it is a NaN that the convs
    smear into valid windows (the reference hit this on the TPU).
    """
    zero = torch.zeros((1,), dtype=v.dtype, device=v.device)
    s = torch.cat([zero, torch.cumsum(v * vm, dim=0)])
    c = torch.cat([zero, torch.cumsum(vm, dim=0)])
    t = v.shape[0]
    i = torch.arange(t, device=v.device)
    lo = torch.clamp(i - k, min=0)
    hi = torch.clamp(i + k, max=t - 1)
    num = s[hi + 1] - s[lo]
    if nonneg:
        num = torch.clamp(num, min=0.0)
    den = torch.clamp(c[hi + 1] - c[lo], min=1.0)
    return num / den


def _aux_channels(x: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """[T, 3] engineered channels: softmax-spectrum flux, its ±0.3 s box
    mean, and local energy-modulation depth; all zero at masked rows and
    computed over valid rows only (``ffsubsync_tpu`` ``_aux_channels``)."""
    p = torch.softmax(x, dim=1)
    prev = torch.cat([p[:1], p[:-1]], dim=0)
    prev_ok = torch.cat([torch.zeros_like(vm[:1]), vm[:-1]])
    flux = 0.5 * torch.sum(torch.abs(p - prev), dim=1) * prev_ok * vm
    e = torch.mean(x, dim=1) * vm
    em = (e - _box_mean(e, vm, 15)) * vm
    mod = torch.sqrt(_box_mean(em * em, vm, 30, nonneg=True) + 1e-6) * vm
    return torch.stack(
        [flux, _box_mean(flux, vm, 30, nonneg=True) * vm, mod], dim=1
    )


class NeuralVADNet(nn.Module):
    """Normalized feats [T, 40] + valid mask [T] -> speech probability [T].

    ``vm`` marks the contiguous run of rows holding real features; the
    caller has zeroed ``x`` outside it. Activations are re-masked after
    every layer so padding rows look like the true out-of-array zeros.
    """

    def __init__(self) -> None:
        super().__init__()
        self.inp = nn.Linear(N_MELS + N_AUX, HIDDEN)
        self.convs = nn.ModuleList(
            nn.Conv1d(HIDDEN, HIDDEN, KERNEL, dilation=d, padding=(KERNEL // 2) * d)
            for d in DILATIONS
        )
        self.out = nn.Linear(HIDDEN, 1)

    def forward(self, x: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x, _aux_channels(x, vm)], dim=1)  # [T, 43]
        mask = vm[None, None, :]
        h = (F.relu(self.inp(x)) * vm[:, None]).T[None]  # [1, H, T]
        for conv in self.convs:
            h = (F.relu(conv(h)) + h) * mask  # residual
        return torch.sigmoid(self.out(h[0].T)[:, 0])


def params_from_numpy(d) -> Dict[str, torch.Tensor]:
    """The JAX parameter layout (``w_in [43,96]``, ``w_conv{i} [K, H_in,
    H_out]``, ``w_out [96,1]`` and biases) as a :class:`NeuralVADNet`
    state dict."""
    sd = {
        "inp.weight": torch.as_tensor(np.asarray(d["w_in"], np.float32)).T,
        "inp.bias": torch.as_tensor(np.asarray(d["b_in"], np.float32)),
        "out.weight": torch.as_tensor(np.asarray(d["w_out"], np.float32)).T,
        "out.bias": torch.as_tensor(np.asarray(d["b_out"], np.float32)),
    }
    for i in range(len(DILATIONS)):
        w = torch.as_tensor(np.asarray(d["w_conv%d" % i], np.float32))
        sd["convs.%d.weight" % i] = w.permute(2, 1, 0)
        sd["convs.%d.bias" % i] = torch.as_tensor(
            np.asarray(d["b_conv%d" % i], np.float32)
        )
    return {k: v.contiguous() for k, v in sd.items()}


def load_net(rate: int, device: torch.device) -> NeuralVADNet:
    """The net with the shipped weights for an analysis rate, on ``device``.

    Missing or stale weights degrade to a deterministic random init with a
    loud warning, as in the reference (whose init differs: the two
    frameworks' generators give different numbers).
    """
    path = default_weights_path(rate)
    net = NeuralVADNet()
    expected = expected_param_shapes()
    loaded = None
    if os.path.exists(path):
        with np.load(path) as f:
            mismatched = sorted(
                k for k in expected
                if k not in f.files or f[k].shape != expected[k]
            )
            if not mismatched:
                loaded = {k: f[k] for k in expected}
            else:
                logger.warning(
                    "neural VAD weights at %s predate the current "
                    "architecture (missing/mis-shaped: %s)", path, mismatched,
                )
    if loaded is not None:
        net.load_state_dict(params_from_numpy(loaded))
    else:
        logger.warning(
            "no usable neural VAD weights at %s; using deterministic random "
            "initialization (detection quality will be poor)", path,
        )
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))
    return net.to(device).eval()


def probs_from_feats(
    net: NeuralVADNet, feats: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """Log-mel feats [T, 40] (rows past ``n_valid`` are padding) -> speech
    probability [T], normalized over the valid rows only
    (``ffsubsync_tpu`` ``_probs_from_feats``)."""
    t = torch.arange(feats.shape[0], device=feats.device)
    mask = (t < n_valid)[:, None]
    denom = max(int(n_valid), 1)
    mean = torch.sum(feats * mask, dim=0, keepdim=True) / denom
    var = torch.sum(((feats - mean) * mask) ** 2, dim=0, keepdim=True) / denom
    x = (feats - mean) / (torch.sqrt(var) + 1e-3)
    x = torch.where(mask, x, 0.0)
    with torch.no_grad():
        return net(x, mask[:, 0].to(feats.dtype))
