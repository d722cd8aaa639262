#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--requests N]

For each seed, one process drives the cell's entry over a fresh pool of
inputs for ``N`` requests in a closed loop (the cell's own load) and
judges every one of them (in a batch, the cell's number of jobs of each)
as a run judges its sample: the lower readings
(the program). On the control seeds it also judges the control, the plain
reference put in the program's place at the precision below the one the
configuration states: the upper readings. Prints one JSON line per seed:
each number's largest reading over the requests, for the program and, where
run, for the control.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seeds, control_seeds, n_requests, require_cuda=True, overrides=None,
             log=print):
    """{seed: {"program": {number: largest}, "control": {...}}}."""
    import torch

    from benchmark.harness import runner, spec, synth
    from benchmark.harness.check import Judge, summary
    from benchmark.harness.spans import Recorder

    if require_cuda and not torch.cuda.is_available():
        raise SystemExit("readings need a CUDA device")
    device = torch.device("cuda" if require_cuda else os.environ.get("FFS_TORCH_DEVICE", "cpu"))
    _e, check_spec, config, traffic = spec.cell(workload)
    for part, extra in (overrides or {}).items():
        {"config": config, "traffic": traffic, "check": check_spec}[part].update(extra)
    entry = spec.entry(traffic["entry"])
    out = {}
    for seed in seeds:
        workdir = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
        try:
            t = time.perf_counter()
            media = synth.make_media(workdir, seed, config, traffic, device)
            os.makedirs(os.path.join(workdir, "out"))
            ctx = runner.Context(media, traffic, os.path.join(workdir, "out"))
            requests = []
            with Recorder() as rec:
                for k in range(n_requests):
                    rec.begin(k, True)
                    requests.append({"k": k, "jobs": entry.request(ctx, k)})
                    rec.end()
            runner._attach(requests, rec, seed, check_spec)
            rec.searches = None
            judge = Judge(runner._weights(config), traffic, device)
            jobs = runner.rec_jobs(requests)
            program = [judge.judge(j) for j in jobs if j["labels"] is not None]
            row = {"seed": seed, "jobs": len(jobs), "judged": len(program),
                   "program": summary(program)}
            row["flips_at"] = _flip_positions(judge, jobs, config)
            if seed in control_seeds:
                row["control"] = summary([judge.control(j) for j in jobs
                                          if j["labels"] is not None])
            row["seconds"] = time.perf_counter() - t
            out[seed] = row
            log(json.dumps(row))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return out


def _flip_positions(judge, jobs, config):
    """Where the program's flipped windows lie within their pipeline chunk
    (windows from the chunk's start) over the distinct films judged: the
    count, the least, the median and how many lie in a chunk's first 6,000
    windows (a 60-s segment's length)."""
    import numpy as np

    chunk = int(config["pipeline_chunk_seconds"] * 100)
    seen, at = set(), []
    for j in jobs:
        if j["labels"] is None or j["wav"] in seen:
            continue
        seen.add(j["wav"])
        d = np.abs(j["labels"] - judge.reference_labels(j["wav"]))
        at.extend((np.nonzero(d > 0.2)[0] % chunk).tolist())
    if not at:
        return {"n": 0}
    return {"n": len(at), "min": int(min(at)), "median": float(np.median(at)),
            "first_6000": int(sum(a < 6000 for a in at))}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--requests", type=int, default=8)
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    readings(args.workload, seeds, control, args.requests)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # the checkout's root: the program and the benchmark package
    os.environ["USE_FLAX"] = "0"
    sys.exit(main())
