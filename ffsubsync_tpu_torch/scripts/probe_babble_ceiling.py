# -*- coding: utf-8 -*-
"""Measure the crowd_babble window-accuracy CEILING with an in-distribution
probe.

Counterpart of the JAX package's ``scripts/probe_babble_ceiling.py``, with
the same flags, data, optimizer, scoring and JSON line (its docstring
states the two hypotheses the probe separates). The SAME architecture is
trained directly on EVAL-FAMILY data (source-filter speech positives,
eval-generator babble negatives: an oracle's training set, never shipped)
and scored beside the shipped net on held-out eval clips. The probe's
features come from the frontend kernel: one launch per training step
(``[batch · clip windows, window]`` int16) and one per scoring clip.

    python -m ffsubsync_tpu_torch.scripts.probe_babble_ceiling [--steps 900]
        [--batch 8] [--clip-seconds 10] [--frame-rate 12000]
        [--platform cuda|cpu]

Prints one JSON line with probe/shipped accuracies per condition.
"""
import argparse
import json
import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ffsubsync_tpu_torch.device import get_device
from ffsubsync_tpu_torch.models import neural_vad
from ffsubsync_tpu_torch.ops.features import log_mel_features
from ffsubsync_tpu_torch.parallel.batch import adam
from ffsubsync_tpu_torch.scripts.train_neural_vad import schedule, train_step

CONDITIONS = ("crowd_babble", "low_snr_pink", "whisper")
# held-out scoring clips per condition, and their seed's distance from the
# training draws
SCORE_CLIPS, SCORE_SECONDS, HELD_OUT_SEED = 6, 30.0, 10_000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _probe_batch(rng, n_clips, clip_seconds, frame_rate, sample_rate):
    """Eval-family training batch: source-filter speech vs babble/noise."""
    from ffsubsync_tpu_torch.models import eval_data as ed

    window = frame_rate // sample_rate
    samples = int(clip_seconds * frame_rate)
    n_windows = samples // window
    pcm = np.zeros((n_clips, samples), np.float32)
    labels = np.zeros((n_clips, n_windows), np.float32)
    for i in range(n_clips):
        x = rng.randn(samples).astype(np.float32) * 0.002
        u = rng.rand()
        if u < 0.45:  # speech (sometimes over a babble bed)
            v, gate = ed._source_filter_speech(rng, samples, frame_rate)
            if rng.rand() < 0.4:
                bed = ed._crowd_babble(rng, samples, frame_rate)
                x += ed._scaled_to_snr(v, bed, rng.uniform(3.0, 12.0))
            x += v
            labels[i] = ed._window_labels(gate, window)
        elif u < 0.9:  # babble negative
            x += ed._crowd_babble(
                rng, samples, frame_rate, voices=rng.randint(8, 17)
            )
        # else: noise-floor negative
        pcm[i] = x
    pcm16 = np.clip(pcm * 32767, -32768, 32767).astype(np.int16)
    return pcm16, labels


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--clip-seconds", type=float, default=10.0)
    ap.add_argument("--frame-rate", type=int, default=12000)
    ap.add_argument("--sample-rate", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None, choices=("cuda", "cpu"),
                    help="device (default: FFS_TORCH_DEVICE, else cuda)")
    return ap


class ProbeRun(NamedTuple):
    net: neural_vad.NeuralVADNet
    losses: List[float]  # per step


def train(args, device: torch.device, init: Optional[dict] = None) -> ProbeRun:
    """``args.steps`` steps on ``_probe_batch`` draws of ``args.seed``: the
    mean over clips of each clip's binary cross-entropy (the trainer's loss
    with unit weights), the global-norm clip and Adam under the trainer's
    schedule at ``args.lr``. ``init`` (the JAX parameter layout) replaces
    ``init_params`` of a generator seeded ``args.seed``."""
    window = args.frame_rate // args.sample_rate
    net = neural_vad.NeuralVADNet()
    net.load_state_dict(neural_vad.params_from_numpy(
        init if init is not None
        else neural_vad.init_params(torch.Generator().manual_seed(args.seed))))
    net = net.to(device).train()
    optimizer = adam(net, 0.0)  # train_step sets each update's rate
    rng = np.random.RandomState(args.seed)
    losses = []
    for i in range(args.steps):
        pcm16, labels = _probe_batch(
            rng, args.batch, args.clip_seconds, args.frame_rate, args.sample_rate,
        )
        losses.append(train_step(net, optimizer, schedule(args, i), pcm16, labels, None,
                                 window, args.sample_rate))
        if i % 100 == 0 or i == args.steps - 1:
            log("step %4d  loss %.4f" % (i, float(losses[-1])))
    return ProbeRun(net, [float(loss) for loss in losses])


def score(net, args, device: torch.device, n_clips: int = SCORE_CLIPS,
          clip_seconds: float = SCORE_SECONDS) -> dict:
    """Window accuracy of ``net`` and of the shipped detector (``silero``)
    on ``n_clips`` held-out clips per condition, generated at the probe's
    own rate so both score identical windows: condition -> {"probe",
    "shipped"}, rounded as the reference rounds them."""
    from ffsubsync_tpu_torch.models.eval_data import condition_clips
    from ffsubsync_tpu_torch.ops.vad import make_detector

    net = net.eval()
    report = {}
    for cond in CONDITIONS:
        clips = condition_clips(
            cond, n_clips, clip_seconds, args.frame_rate, args.sample_rate,
            seed=args.seed + HELD_OUT_SEED,  # held out from probe training draws
        )
        hits_p = hits_s = total = 0
        for pcm16, labels, mask in clips:
            n = len(labels)
            with torch.no_grad():
                feats = log_mel_features(pcm16[None], args.frame_rate, args.sample_rate, device)
                pp = neural_vad.apply_model(net, feats)[0].cpu().numpy()[:n] > 0.5
            shipped = make_detector("silero", args.sample_rate, args.frame_rate, 0.0, device)
            sp = np.asarray(shipped(pcm16.tobytes()))[:n] > 0.5
            want = labels[:n] > 0.5
            hits_p += int(((pp == want) & mask[:n]).sum())
            hits_s += int(((sp == want) & mask[:n]).sum())
            total += int(mask[:n].sum())
        report[cond] = {
            "probe": round(hits_p / max(total, 1), 3),
            "shipped": round(hits_s / max(total, 1), 3),
        }
        log("%s: probe %.3f shipped %.3f" % (cond, *[
            report[cond][k] for k in ("probe", "shipped")
        ]))
    return report


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    device = torch.device(args.platform) if args.platform else get_device()
    run = train(args, device)
    report = score(run.net, args, device)
    print(json.dumps({"metric": "babble_ceiling_probe", **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
