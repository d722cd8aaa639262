#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Chunk-count sensitivity of the 90-min VAD pipeline (diagnostic).

Counterpart of the JAX package's ``scripts/diag_chunks.py``, with its
arguments, its sweep and its stderr lines. The fused VAD pipeline over the
90-minute problem of ``scripts/bench.make_problem`` runs once per
``FFS_TPU_PIPELINE_SECONDS`` setting (0, the one-launch pipeline, then
2700, 1350, 600 and 300 s): one warm run, then ``runs`` runs each with a
fresh detector built outside the timed window, each ending in a
synchronize. Each setting prints its launch count, the warm time and the
best and all timed runs. ``main`` puts the variable back as it found it.

It runs on the card (``FFS_TORCH_DEVICE`` unset or ``cuda``) and raises
without one; ``FFS_TORCH_DEVICE=cpu`` runs the port's plain PyTorch path
on the CPU. The last stderr line is ``frontend kernel launches: N``. A
runs count below 1 raises ``ValueError``.

Usage: python -m ffsubsync_tpu_torch.scripts.diag_chunks [minutes] [runs]
"""
import os
import sys
import time

from ffsubsync_tpu_torch.constants import SAMPLE_RATE
from ffsubsync_tpu_torch.device import get_device
from ffsubsync_tpu_torch.ops.features import analysis_rate
from ffsubsync_tpu_torch.ops.vad import make_detector
from ffsubsync_tpu_torch.scripts.bench import log, log_launches, make_problem
from ffsubsync_tpu_torch.scripts.diag_breakdown import describe, parse_argv, vad

SETTINGS = ("0", "2700", "1350", "600", "300")
PIPELINE_ENV = "FFS_TPU_PIPELINE_SECONDS"


def sweep(pcm, frame_rate, runs, device):
    """The fused pipeline at each of ``SETTINGS``, one line each."""

    def fused():
        return make_detector("fused", SAMPLE_RATE, frame_rate, 0.0, device)

    for seconds in SETTINGS:
        os.environ[PIPELINE_ENV] = seconds
        det = fused()
        t0 = time.perf_counter()
        signal = vad(det, pcm, device)
        warm = time.perf_counter() - t0
        ts = []
        for _ in range(runs):
            det = fused()
            t0 = time.perf_counter()
            vad(det, pcm, device)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        log("pipeline_seconds=%s (%d launches): warm %.2f s, best %.3f s, all %s"
            % (seconds, len(signal._parts), warm, ts[0], [round(x, 3) for x in ts]))


def main(argv=None):
    minutes, runs = parse_argv(sys.argv[1:] if argv is None else argv)
    device = get_device()
    frame_rate = analysis_rate(48000, SAMPLE_RATE)
    log("device:", describe(device))
    pcm = make_problem(minutes, frame_rate)[0]
    before = os.environ.get(PIPELINE_ENV)
    try:
        sweep(pcm, frame_rate, runs, device)
    finally:
        if before is None:
            os.environ.pop(PIPELINE_ENV, None)
        else:
            os.environ[PIPELINE_ENV] = before
    log_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
