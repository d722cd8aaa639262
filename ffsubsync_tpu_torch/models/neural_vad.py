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
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ffsubsync_tpu_torch.utils import tracing

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


def init_params(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A fresh net in the JAX layout, drawn as ``ffsubsync_tpu``'s
    ``init_params`` draws it: each weight a standard normal over the square
    root of its fan-in (43 for ``w_in``, 96 for ``w_out``, 5·96 for a conv)
    and every bias zero. The numbers come from ``generator``, not from
    JAX's PRNG, so only the distributions match."""
    n_in = N_MELS + N_AUX
    params: Dict[str, torch.Tensor] = {
        "w_in": torch.randn((n_in, HIDDEN), generator=generator) / np.sqrt(n_in),
        "b_in": torch.zeros((HIDDEN,)),
        "w_out": torch.randn((HIDDEN, 1), generator=generator) / np.sqrt(HIDDEN),
        "b_out": torch.zeros((1,)),
    }
    for i in range(len(DILATIONS)):
        params["w_conv%d" % i] = torch.randn(
            (KERNEL, HIDDEN, HIDDEN), generator=generator
        ) / np.sqrt(KERNEL * HIDDEN)
        params["b_conv%d" % i] = torch.zeros((HIDDEN,))
    return params


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


def _box_sums(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each centered ±k box's sum of a [..., T] series (zeros past its
    ends), every box summed directly in one fixed order."""
    return F.pad(x, (k, k)).unfold(-1, 2 * k + 1, 1).sum(dim=-1)


def _box_mean(
    v: torch.Tensor, vm: torch.Tensor, k: int, nonneg: bool = False
) -> torch.Tensor:
    """Centered ±k box mean of a [..., T] series over its valid rows only.

    On the CPU the box sums are differences of float32 prefix sums, as in
    the reference. On CUDA each box is summed directly, in a fixed order:
    ``torch.cumsum`` of a 1-D float series there is a single-pass scan
    whose tiles take their predecessors' prefixes as timing allows, so its
    rounding, and the labels with it, would differ from run to run.

    ``nonneg=True`` declares the input non-negative and clamps the result at
    zero: a difference of prefix sums, ``s[hi+1] - s[lo]``, on a near-silent
    stretch of a movie-length series can come out slightly negative, and
    ``sqrt`` of it is a NaN that the convs smear into valid windows (the
    reference hit this on the TPU).
    """
    if v.is_cuda:
        num, count = _box_sums(v * vm, k), _box_sums(vm, k)
    else:
        zero = torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
        s = torch.cat([zero, torch.cumsum(v * vm, dim=-1)], dim=-1)
        c = torch.cat([zero, torch.cumsum(vm, dim=-1)], dim=-1)
        t = v.shape[-1]
        i = torch.arange(t, device=v.device)
        lo = torch.clamp(i - k, min=0)
        hi = torch.clamp(i + k, max=t - 1)
        num, count = s[..., hi + 1] - s[..., lo], c[..., hi + 1] - c[..., lo]
    if nonneg:
        num = torch.clamp(num, min=0.0)
    return num / torch.clamp(count, min=1.0)


def _aux_channels(x: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """[..., T, 3] engineered channels of feats [..., T, 40]: softmax-spectrum
    flux, its ±0.3 s box mean, and local energy-modulation depth; all zero
    at masked rows and computed over valid rows only (``ffsubsync_tpu``
    ``_aux_channels``)."""
    p = torch.softmax(x, dim=-1)
    prev = torch.cat([p[..., :1, :], p[..., :-1, :]], dim=-2)
    prev_ok = torch.cat([torch.zeros_like(vm[..., :1]), vm[..., :-1]], dim=-1)
    flux = 0.5 * torch.sum(torch.abs(p - prev), dim=-1) * prev_ok * vm
    e = torch.mean(x, dim=-1) * vm
    em = (e - _box_mean(e, vm, 15)) * vm
    mod = torch.sqrt(_box_mean(em * em, vm, 30, nonneg=True) + 1e-6) * vm
    return torch.stack(
        [flux, _box_mean(flux, vm, 30, nonneg=True) * vm, mod], dim=-1
    )


class NeuralVADNet(nn.Module):
    """Normalized feats [T, 40] + valid mask [T] -> speech probability [T],
    or a batch of clips: [B, T, 40] + [B, T] -> [B, T].

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
        single = vm.dim() == 1
        if single:  # one clip: a batch of 1
            x, vm = x[None], vm[None]
        x = torch.cat([x, _aux_channels(x, vm)], dim=-1)  # [B, T, 43]
        h = (F.relu(self.inp(x)) * vm[..., None]).transpose(-1, -2)  # [B, H, T]
        mask = vm[:, None, :]
        for conv in self.convs:
            h = (F.relu(conv(h)) + h) * mask  # residual
        p = torch.sigmoid(self.out(h.transpose(-1, -2))[..., 0])
        return p[0] if single else p


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


def params_to_numpy(net: NeuralVADNet) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`: the net's parameters as
    float32 numpy arrays in the JAX layout (the shipped .npz files')."""
    return jax_layout(net.state_dict())


def jax_layout(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors named as :class:`NeuralVADNet`'s parameters (the parameters,
    their gradients, an optimizer's moments) as float32 numpy arrays in the
    JAX layout: dense weights transposed, conv ``[H_out, H_in, K]`` back to
    ``[K, H_in, H_out]``."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    d = {
        "w_in": sd["inp.weight"].T,
        "b_in": sd["inp.bias"],
        "w_out": sd["out.weight"].T,
        "b_out": sd["out.bias"],
    }
    for i in range(len(DILATIONS)):
        d["w_conv%d" % i] = sd["convs.%d.weight" % i].permute(2, 1, 0)
        d["b_conv%d" % i] = sd["convs.%d.bias" % i]
    # copies: a CPU tensor's .numpy() shares the live parameter's memory
    return {k: np.array(v.numpy(), dtype=np.float32, order="C") for k, v in d.items()}


# The nets read in this process, by (weights path, that file's (st_mtime_ns,
# st_size) or None, analysis rate, device): each eval-mode with no parameter
# requiring grad, beside the warnings its read logged. The net's forward has
# no buffers and no state, so one module serves every detector and thread.
_nets: Dict[tuple, Tuple[NeuralVADNet, List[tuple]]] = {}
_net_locks: Dict[tuple, threading.Lock] = {}
_nets_lock = threading.Lock()


def _file_identity(path: str) -> Optional[Tuple[int, int]]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_mtime_ns, st.st_size


def _device_key(device: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current device>`` are one device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@tracing.spanned("net_read")
def _read_net(path: str, device: torch.device) -> Tuple[NeuralVADNet, List[tuple]]:
    """The net with the weights at ``path`` on ``device``, and the warnings
    to log (each a logger's arguments). Counted as ``net_load.reads``."""
    tracing.count("net_load.reads")
    net = NeuralVADNet()
    expected = expected_param_shapes()
    warnings = []
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
                warnings.append((
                    "neural VAD weights at %s predate the current "
                    "architecture (missing/mis-shaped: %s)", path, mismatched,
                ))
    if loaded is None:
        warnings.append((
            "no usable neural VAD weights at %s; using deterministic random "
            "initialization (detection quality will be poor)", path,
        ))
        loaded = init_params(torch.Generator().manual_seed(0))
    net.load_state_dict(params_from_numpy(loaded))
    return net.to(device).eval().requires_grad_(False), warnings


@tracing.spanned("net_load")
def load_net(rate: int, device: torch.device) -> NeuralVADNet:
    """The net with the shipped weights for an analysis rate, on ``device``.

    Missing or stale weights degrade to :func:`init_params` of a generator
    seeded 0, with a loud warning on every call, as in the reference (the
    distributions are the reference's; the numbers drawn differ).

    The net is read once per process for each weights file (its path, its
    ``st_mtime_ns`` and size, so a rewritten file is read again), rate and
    device, and shared: it is in eval mode and no parameter requires grad,
    so callers must not train or change it. Threads that ask at once for a
    net not yet read wait for one read. Each call is an acquisition, the
    span ``net_load`` and the counter ``net_load.calls``; a real read is
    the span ``net_read`` inside it and the counter ``net_load.reads``
    (:func:`tracing.counts`). :func:`clear_net_cache` forgets every net.
    """
    tracing.count("net_load.calls")
    path = default_weights_path(rate)
    device = _device_key(device)
    key = (path, _file_identity(path), rate, device)
    entry = _nets.get(key)
    if entry is None:
        with _nets_lock:
            lock = _net_locks.setdefault(key, threading.Lock())
        with lock:
            entry = _nets.get(key)
            if entry is None:
                entry = _nets[key] = _read_net(path, device)
    net, warnings = entry
    for args in warnings:
        logger.warning(*args)
    return net


def clear_net_cache() -> None:
    """Forget every net :func:`load_net` read: the next call reads again."""
    with _nets_lock:
        _nets.clear()
        _net_locks.clear()


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


def apply_model(net: NeuralVADNet, feats: torch.Tensor) -> torch.Tensor:
    """Log-mel feats [T, 40] or [B, T, 40] -> speech probability [T] or
    [B, T], each clip normalized over all its rows (population std, as
    ``jnp.std``) and every row valid (``ffsubsync_tpu`` ``apply_model``).
    Differentiable: the trainer's forward pass."""
    mean = torch.mean(feats, dim=-2, keepdim=True)
    std = torch.std(feats, dim=-2, keepdim=True, correction=0) + 1e-3
    vm = torch.ones(feats.shape[:-1], dtype=feats.dtype, device=feats.device)
    return net((feats - mean) / std, vm)


def vad_loss(
    net: NeuralVADNet,
    feats: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    total_weight: float,
) -> torch.Tensor:
    """The trainer's loss over clips [B, T, 40] with window labels [B, T']
    and weights [B]: each clip's mean binary cross-entropy ``-(y log(p +
    1e-6) + (1 - y) log(1 - p + 1e-6))`` over its first T' windows, then
    ``Σ wᵢ lossᵢ / total_weight``. A share of a larger batch passes the
    whole batch's weight, so the shares' losses (and gradients) add up to
    the batch's."""
    probs = apply_model(net, feats)[:, : labels.shape[1]]
    eps = 1e-6
    bce = -(labels * torch.log(probs + eps) + (1 - labels) * torch.log(1 - probs + eps))
    return torch.sum(torch.mean(bce, dim=1) * weights) / total_weight
