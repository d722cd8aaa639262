# -*- coding: utf-8 -*-
"""Plain neural VAD forward: normalized log-mel [T, 40] plus three
engineered channels (softmax-spectrum flux, its +-30-window mean, the
+-30-window depth of energy modulation) -> dense 43 -> 96 (ReLU) -> seven
residual dilated convolutions (kernel 5, dilations 1..64, SAME padding,
ReLU) -> dense 96 -> 1 -> sigmoid. Every layer is masked to the valid
rows. The weights are the shipped ``.npz`` (JAX layout: ``w_in [43, 96]``,
``w_conv{i} [5, 96, 96]``, ``w_out [96, 1]``), read as data.

``precision="float64"`` is the reference; ``"tf32"`` the control: float32
with every product's operands rounded to TF32 and every activation kept in
bfloat16 between layers.
"""
import numpy as np
import torch

from benchmark.reference.frontend import tf32

DILATIONS = (1, 2, 4, 8, 16, 32, 64)
KERNEL = 5
CONTEXT = 320


def load_weights(path, precision, device):
    dtype = torch.float64 if precision == "float64" else torch.float32
    with np.load(path) as f:
        return {k: torch.from_numpy(np.asarray(f[k], np.float64)).to(device=device, dtype=dtype)
                for k in f.files}


def _mm(a, b, precision):
    return a @ b if precision == "float64" else tf32(a) @ tf32(b)


def _box(v, vm, k, nonneg=False):
    zero = torch.zeros(1, dtype=v.dtype, device=v.device)
    s = torch.cat([zero, torch.cumsum(v * vm, 0)])
    c = torch.cat([zero, torch.cumsum(vm, 0)])
    i = torch.arange(v.shape[0], device=v.device)
    lo = torch.clamp(i - k, min=0)
    hi = torch.clamp(i + k, max=v.shape[0] - 1)
    num = s[hi + 1] - s[lo]
    if nonneg:
        num = torch.clamp(num, min=0.0)
    return num / torch.clamp(c[hi + 1] - c[lo], min=1.0)


def _store(x, precision):
    """The control keeps every activation in bfloat16 between layers."""
    return x if precision == "float64" else x.to(torch.bfloat16).to(x.dtype)


def forward(w, x, vm, precision):
    """Speech probability [T] of normalized features ``x`` [T, 40] (zero
    outside the valid rows ``vm`` [T])."""
    x = _store(x, precision)
    p = torch.softmax(x, dim=-1)
    prev = torch.cat([p[:1], p[:-1]])
    prev_ok = torch.cat([torch.zeros_like(vm[:1]), vm[:-1]])
    flux = 0.5 * torch.abs(p - prev).sum(-1) * prev_ok * vm
    e = x.mean(-1) * vm
    em = (e - _box(e, vm, 15)) * vm
    mod = torch.sqrt(_box(em * em, vm, 30, nonneg=True) + 1e-6) * vm
    aux = _store(torch.stack([flux, _box(flux, vm, 30, nonneg=True) * vm, mod], -1), precision)
    h = _store(torch.relu(_mm(torch.cat([x, aux], -1), w["w_in"], precision) + w["b_in"])
               * vm[:, None], precision)
    t = h.shape[0]
    for i, d in enumerate(DILATIONS):
        pad = (KERNEL // 2) * d
        hp = torch.nn.functional.pad(h, (0, 0, pad, pad))
        acc = w["b_conv%d" % i].expand(t, -1).clone()
        for j in range(KERNEL):
            acc = acc + _mm(hp[j * d: j * d + t], w["w_conv%d" % i][j], precision)
        h = _store((torch.relu(acc) + h) * vm[:, None], precision)
    return torch.sigmoid(_mm(h, w["w_out"], precision) + w["b_out"])[:, 0]


def fresh_state(device, dtype):
    return {"carry": torch.zeros((CONTEXT, 40), device=device, dtype=dtype), "carry_len": 0}


def probs(w, logmel, state, precision):
    """Speech probabilities [T] of one chunk's log-mel (numpy [T, 40]),
    normalized over the carried context and the chunk, and the new state."""
    carry = state["carry"]
    feats = torch.cat([carry, torch.from_numpy(logmel).to(carry.device, carry.dtype)])
    t = logmel.shape[0]
    rows = torch.arange(feats.shape[0], device=feats.device)
    valid = (rows >= CONTEXT - state["carry_len"]) & (rows < CONTEXT + t)
    mask = valid[:, None]
    denom = max(state["carry_len"] + t, 1)
    mean = (feats * mask).sum(0, keepdim=True) / denom
    var = (((feats - mean) * mask) ** 2).sum(0, keepdim=True) / denom
    x = torch.where(mask, (feats - mean) / (torch.sqrt(var) + 1e-3), 0.0)
    out = forward(w, x, valid.to(feats.dtype), precision)[CONTEXT:]
    new = {"carry": feats[t: t + CONTEXT], "carry_len": min(state["carry_len"] + t, CONTEXT)}
    return out.to(torch.float64).cpu().numpy(), new
