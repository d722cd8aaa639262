# -*- coding: utf-8 -*-
"""Seed-sweep protocol behind the `noisy` scenario's 30 ms bar (EVAL.md).

Counterpart of the JAX package's ``scripts/probe_noisy_jitter.py``, with
the same flags, protocol and JSON line. The claim being made reproducible:
under the 4 dB pink bed, a 3-minute clip's correlation peak jitters by 1-3
label cells with random sign and backend (the harness's short-clip
measurement variance, NOT detector bias), and the jitter vanishes at
10-minute clip length. Its JSON output is the artifact
(``EVAL_noisy_jitter.json`` holds the reference's).

Protocol: run the full end-to-end agreement harness (``sync.run`` per
backend, :mod:`ffsubsync_tpu_torch.scripts.eval_vad_agreement`) on the
`noisy` scenario at 3-minute and 10-minute clip lengths across several
seeds, and report each backend's offset deviation in 10 ms cells per
(seed, length). Interpretation guide:

- deviation cells vary in SIGN and strike DIFFERENT backends at different
  seeds  -> measurement variance (bias would be one-sided and systematic);
- max |cells| at 10 min << max |cells| at 3 min  -> short-clip effect;
- a weights retrain shifting WHICH seeds deviate but not the envelope
  -> weights-independent.

Usage::

    python -m ffsubsync_tpu_torch.scripts.probe_noisy_jitter
        [--seeds 0,100,200,300] [--lengths 3,10] [--vads fused,silero]
        [--frame-rate 12000] [--platform cuda|cpu]

Prints one JSON line. Runtime is ~n_seeds x n_lengths x n_vads full syncs
(each 3/10-minute movie synthesized + synced once per backend).
"""
import argparse
import json
import os
import sys

from ffsubsync_tpu_torch.scripts import eval_vad_agreement as agreement


def sweep(vads, seeds, lengths, frame_rate) -> dict:
    """The protocol's report (the JSON line's object)."""
    rows = []
    for minutes in lengths:
        for seed in seeds:
            report = agreement.run_synthetic(
                vads, minutes, frame_rate, seed, scenarios=["noisy"]
            )
            row = report["per_scenario"]["noisy"]
            cells = {
                vad: (
                    None
                    if row[vad] is None
                    else int(round((row[vad] - row["truth"]) * 100.0))
                )
                for vad in vads
            }
            print(
                "  %4.1f min seed %-4d -> %s"
                % (
                    minutes,
                    seed,
                    " ".join("%s %+d" % (v, c) for v, c in cells.items()),
                ),
                file=sys.stderr,
                flush=True,
            )
            rows.append({"minutes": minutes, "seed": seed, "cells": cells})

    def _env(minutes):
        vals = [
            abs(c)
            for r in rows
            if r["minutes"] == minutes
            for c in r["cells"].values()
            if c is not None
        ]
        return max(vals) if vals else None

    return {
        "metric": "noisy_offset_jitter_cells",
        "unit": "10ms cells (deviation from truth)",
        "frame_rate": frame_rate,
        "sweep": rows,
        "max_abs_cells_per_length": {str(m): _env(m) for m in lengths},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,100,200,300")
    ap.add_argument("--lengths", default="3,10", help="clip minutes to sweep")
    ap.add_argument("--vads", default="fused,silero")
    ap.add_argument("--frame-rate", type=int, default=12000)
    ap.add_argument("--platform", default=None, choices=("cuda", "cpu"),
                    help="device (sets FFS_TORCH_DEVICE for the syncs)")
    args = ap.parse_args(argv)
    if args.platform:
        os.environ["FFS_TORCH_DEVICE"] = args.platform
    report = sweep(
        args.vads.split(","),
        [int(s) for s in args.seeds.split(",")],
        [float(m) for m in args.lengths.split(",")],
        args.frame_rate,
    )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
