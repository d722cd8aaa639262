# -*- coding: utf-8 -*-
"""Train the in-tree neural VAD on synthetic speech/non-speech audio.

Counterpart of the JAX package's ``scripts/train_neural_vad.py``, with the
same flags, defaults, data and optimizer: batches from
``models/synth_data.synth_batch``, their log-mel features from the frontend
kernel (one launch per step on a CUDA device), the weighted binary
cross-entropy, a global-norm clip at 1.0 and Adam under a linear-warmup
cosine schedule, each written to compute what optax computes. The weights
are written in the JAX layout, so either package loads them.

    python -m ffsubsync_tpu_torch.scripts.train_neural_vad [--steps 600]
        [--frame-rate 48000] [--platform cuda|cpu] [--out path.npz]

Without ``--out`` the file goes to this package's weights directory as
``neural_vad_weights_<frame rate>.npz``, which the detectors of that rate
then load.
"""
import argparse
import math
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ffsubsync_tpu_torch.device import get_device
from ffsubsync_tpu_torch.models import neural_vad
from ffsubsync_tpu_torch.models.synth_data import synth_batch
from ffsubsync_tpu_torch.ops.features import log_mel_features
from ffsubsync_tpu_torch.parallel.batch import adam, vad_batch_gradients

MAX_GRAD_NORM = 1.0
HELD_OUT_CLIPS = 16


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--clip-seconds", type=float, default=10.0)
    ap.add_argument("--frame-rate", type=int, default=48000)
    ap.add_argument("--sample-rate", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--platform", default=None, choices=("cuda", "cpu"),
                    help="device (default: FFS_TORCH_DEVICE, else cuda)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def warmup_cosine_decay(
    count: int, init_value: float, peak_value: float, warmup_steps: int,
    decay_steps: int, end_value: float = 0.0,
) -> float:
    """``optax.warmup_cosine_decay_schedule(...)(count)``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine down
    to ``end_value`` over ``decay_steps - warmup_steps``, held there after.
    Like optax, it refuses a cosine phase of no steps."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("the cosine phase needs decay_steps > warmup_steps, got %d and %d"
                         % (decay_steps, warmup_steps))
    if count < warmup_steps:
        frac = 1.0 - max(count, 0) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup_steps, span) / span))
    return peak_value * ((1.0 - alpha) * cosine + alpha)


def schedule(args, count: int) -> float:
    """The learning rate of update ``count`` (0 for the first), as the JAX
    trainer sets it up."""
    return warmup_cosine_decay(
        count, 0.0, args.lr, warmup_steps=min(100, max(args.steps // 10, 1)),
        decay_steps=max(args.steps, 1), end_value=args.lr * 0.05,
    )


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: each gradient scaled by
    ``max_norm / ‖g‖`` where the norm over all of them reaches
    ``max_norm``, computed on the device (no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


def train_step(net, optimizer, lr: float, pcm16, labels, weights, window: int,
               sample_rate: int) -> torch.Tensor:
    """One update: the weighted loss and its gradients on the net's device,
    the clip, then Adam at ``lr``. Returns the loss (on the device)."""
    device = next(net.parameters()).device
    loss = vad_batch_gradients(net, (device,), {}, pcm16, labels, window,
                               sample_rate, weights)
    clip_by_global_norm([p.grad for p in net.parameters()], MAX_GRAD_NORM)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return loss


def held_out_accuracy(net, args, device: torch.device) -> float:
    """Window accuracy on ``HELD_OUT_CLIPS`` clips of seed + 1 (one feature
    launch for all of them)."""
    pcm16, labels = synth_batch(
        np.random.RandomState(args.seed + 1), HELD_OUT_CLIPS, args.clip_seconds,
        args.frame_rate, args.sample_rate,
    )
    with torch.no_grad():
        feats = log_mel_features(pcm16, args.frame_rate, args.sample_rate, device)
        probs = neural_vad.apply_model(net, feats)[:, : labels.shape[1]].cpu().numpy()
    return float(np.mean((probs > 0.5) == (labels > 0.5)))


class TrainResult(NamedTuple):
    net: neural_vad.NeuralVADNet
    losses: np.ndarray  # per step
    accuracy: float  # held out
    out: str  # the weights file written
    synth_ms: np.ndarray  # host milliseconds of synth_batch, per step
    step_ms: Optional[np.ndarray]  # device milliseconds per step (CUDA events)
    wall_s: float  # the training loop


def train(args) -> TrainResult:
    device = torch.device(args.platform) if args.platform else get_device()
    window = args.frame_rate // args.sample_rate
    net = neural_vad.NeuralVADNet()
    net.load_state_dict(neural_vad.params_from_numpy(
        neural_vad.init_params(torch.Generator().manual_seed(args.seed))))
    net = net.to(device).train()
    optimizer = adam(net, 0.0)  # train_step sets each update's rate
    on_card = device.type == "cuda"
    rng = np.random.RandomState(args.seed)
    losses, synth_ms, events = [], [], []
    t_loop = time.perf_counter()
    for i in range(args.steps):
        t0 = time.perf_counter()
        pcm16, labels, weights = synth_batch(
            rng, args.batch, args.clip_seconds, args.frame_rate,
            args.sample_rate, return_weights=True,
        )
        synth_ms.append((time.perf_counter() - t0) * 1e3)
        if on_card:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        losses.append(train_step(net, optimizer, schedule(args, i), pcm16, labels,
                                 weights, window, args.sample_rate))
        if on_card:
            events[-1][1].record()
        if i % 50 == 0 or i == args.steps - 1:
            print("step %4d  loss %.4f" % (i, float(losses[-1])), flush=True)
    if on_card:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_loop
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    step_ms = np.array([a.elapsed_time(b) for a, b in events]) if on_card else None

    acc = held_out_accuracy(net, args, device)
    print("held-out window accuracy: %.3f" % acc)
    # rate-suffixed: the loader prefers neural_vad_weights_<rate>.npz for
    # the matching analysis rate, so a rate-less path would be shadowed
    out = args.out or os.path.join(
        os.path.dirname(neural_vad.default_weights_path()),
        "neural_vad_weights_%d.npz" % args.frame_rate,
    )
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **neural_vad.params_to_numpy(net))
    print("wrote", out)
    if args.steps:
        print("timing: %d steps in %.3f s; synth_batch %.3f ms per batch on the host "
              "(median), %.4f of the loop; device step %s ms (median, CUDA events "
              "around features, forward, backward and optimizer)"
              % (args.steps, wall, float(np.median(synth_ms)), sum(synth_ms) / 1e3 / wall,
                 "%.4f" % float(np.median(step_ms)) if step_ms is not None else "n/a"))
    return TrainResult(net, losses, acc, out, np.array(synth_ms), step_ms, wall)


def main(argv=None) -> int:
    train(make_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
