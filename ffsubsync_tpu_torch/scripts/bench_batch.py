#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Batch-sync throughput benchmark: N episodes scored over the device mesh.

Counterpart of the JAX package's ``scripts/bench_batch.py``, with its
knobs, timing and JSON line. BASELINE.json's batch configuration: 10
episodes of 45 minutes, each with its own candidate framerate-ratio set,
scored in one batched search (``parallel/batch.BatchAligner`` over its
default mesh, ``local_mesh(get_device())``). The references are 0/1 speech
signals already, so no frontend kernel runs (``frontend kernel launches:
0`` on stderr).

Usage: python -m ffsubsync_tpu_torch.scripts.bench_batch

Prints ONE JSON line: the reference's keys, plus ``platform`` (the torch
device type) and ``device`` (the card's ``nvidia-smi`` name and power
limit, null on the CPU). ``n_chips`` counts the mesh's distinct devices.
Env knobs: BENCH_EPISODES (10), BENCH_MINUTES (45), BENCH_RUNS (3),
BENCH_PLATFORM (``cuda`` by default, or ``cpu``).
"""
import json
import os
import sys
import time

import numpy as np

from ffsubsync_tpu_torch.scripts.bench import (
    card_line, log, log_launches, runs_knob, select_device,
)


def make_episodes(episodes, minutes):
    """``episodes`` speech occupancy patterns of ``minutes`` at 100 Hz
    (``RandomState(0)``), each with a known offset in ±3000 samples and its
    candidate set, one spec per framerate ratio. Returns (refs, candidates,
    true offsets)."""
    from ffsubsync_tpu_torch.constants import FRAMERATE_RATIOS, SAMPLE_RATE
    from ffsubsync_tpu_torch.subs.raster import RasterSpec

    n = int(minutes * 60 * SAMPLE_RATE)
    ratios = [1.0] + FRAMERATE_RATIOS + [1.0 / r for r in FRAMERATE_RATIOS]
    rng = np.random.RandomState(0)
    refs = []
    candidates = []
    true_offsets = []
    for _ in range(episodes):
        sig = np.zeros(n, np.float32)
        t = 200
        spans = []
        while t < n - 600:
            length = rng.randint(100, 400)
            sig[t : t + length] = 1.0
            spans.append((t, t + length))
            t += length + rng.randint(80, 400)
        off = int(rng.randint(-3000, 3000))
        true_offsets.append(off)
        specs = []
        for ratio in ratios:
            starts = np.array(
                [max(0, int(round((a - off) * ratio))) for a, _ in spans],
                np.int32,
            )
            ends = np.array(
                [max(0, int(round((b - off) * ratio))) for _, b in spans],
                np.int32,
            )
            specs.append(
                RasterSpec(
                    n_samples=int(n * ratio) + 2,
                    starts=starts,
                    ends=ends,
                    weight=min(1.0 / ratio, 1.0),
                    max_time=n / float(SAMPLE_RATE),
                    sample_rate=SAMPLE_RATE,
                )
            )
        refs.append(sig)
        candidates.append(specs)
    return refs, candidates, true_offsets


def distinct_devices(mesh):
    """The number of distinct devices in a mesh (one may repeat)."""
    return len(set(mesh))


def main() -> int:
    device = select_device()
    card = card_line(device)

    from ffsubsync_tpu_torch.constants import SAMPLE_RATE
    from ffsubsync_tpu_torch.parallel.batch import BatchAligner

    episodes = int(os.environ.get("BENCH_EPISODES", "10"))
    minutes = float(os.environ.get("BENCH_MINUTES", "45"))
    n_runs = runs_knob("BENCH_RUNS", "3")
    refs, candidates, true_offsets = make_episodes(episodes, minutes)

    aligner = BatchAligner()
    n_chips = distinct_devices(aligner.mesh)
    log("mesh:", aligner.mesh, card or "")

    def run_once():
        return aligner.align_batch(
            refs, candidates, max_offset_samples=60 * SAMPLE_RATE
        )

    log("warmup (cuFFT plans)...")
    t0 = time.perf_counter()
    results = run_once()
    log("warmup took %.2f s" % (time.perf_counter() - t0))
    run_times = []
    for i in range(n_runs):
        # align_batch pulls every score and offset to the host before it
        # returns, so the window closes after the card's work
        t0 = time.perf_counter()
        results = run_once()
        run_s = time.perf_counter() - t0
        log("run %d: %.3f s" % (i, run_s))
        run_times.append(run_s)
    run_times.sort()
    elapsed = run_times[0]

    errs = []
    for i in range(episodes):
        best = max(results[i], key=lambda a: a.score)
        errs.append(abs(best.offset - true_offsets[i]))
    log("offset errors (samples):", errs)
    ok = max(errs) <= 1
    syncs_per_sec_chip = episodes / elapsed / n_chips
    # baseline: the reference syncs serially at ~25 s/episode on one CPU
    vs_baseline = (episodes / elapsed) / (episodes / (25.0 * episodes))
    log_launches()
    print(
        json.dumps(
            {
                "metric": "45min_batch_syncs_per_sec_per_chip",
                "value": round(syncs_per_sec_chip, 4),
                "unit": "syncs/sec/chip",
                "vs_baseline": round(vs_baseline, 2),
                "offsets_exact": bool(ok),
                "timing": "best-of-%d" % len(run_times),
                "best_s": round(run_times[0], 3),
                "median_s": round(run_times[len(run_times) // 2], 3),
                "worst_s": round(run_times[-1], 3),
                "platform": device.type,
                "device": card,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
