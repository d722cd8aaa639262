# -*- coding: utf-8 -*-
"""Reproducible protocol for the webrtc-class music-scenario offset bias.

Counterpart of the JAX package's ``scripts/probe_webrtc_bias.py``, with the
same flags, ``--out`` and JSON line. Each (seed, length) runs the agreement
harness in a process of its own (``python -m
ffsubsync_tpu_torch.scripts.eval_vad_agreement --vads webrtc``) and the
signed offset error of every music scenario is read from its JSON line.
The reference's probe showed the webrtc-class kernel's music errors to be
short-clip variance of either sign around a small mean, not a one-sided
release lag (``_PRE_HANGOVER_WINDOWS`` symmetrizes the dilation); this one
re-measures them so the EVAL.md bars stay tied to a re-runnable
measurement (``EVAL_webrtc_bias.json`` holds the reference's).

Usage: python -m ffsubsync_tpu_torch.scripts.probe_webrtc_bias
       [--seeds 1,2,3,4,5,6,7,8] [--minutes 3,10] [--scenarios music_bed,
       vocals_bed,strings_bed,laughter_breaks] [--out EVAL_webrtc_bias.json]

The harness's syncs run on the device ``FFS_TORCH_DEVICE`` names (``cuda``
by default). The frontend kernel's launches in the harness's processes
are summed on standard error (``frontend kernel launches: N``).
"""
import argparse
import json
import os
import re
import subprocess
import sys

# the directory that holds this package, for the harness's processes
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LAUNCHES = re.compile(r"^frontend kernel launches: (\d+)$", re.M)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1,2,3,4,5,6,7,8")
    ap.add_argument("--minutes", default="3,10")
    ap.add_argument(
        "--scenarios",
        default="music_bed,vocals_bed,strings_bed,laughter_breaks",
    )
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    minute_list = [float(m) for m in args.minutes.split(",")]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])

    report = {"metric": "webrtc_music_offset_error_s", "by_minutes": {}}
    launches = 0
    for minutes in minute_list:
        per_seed = {}
        for seed in seeds:
            cmd = [
                sys.executable,
                "-m",
                "ffsubsync_tpu_torch.scripts.eval_vad_agreement",
                "--seed",
                str(seed),
                "--minutes",
                str(minutes),
                "--vads",
                "webrtc",
                "--scenarios",
                args.scenarios,
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
            if proc.returncode:
                log(proc.stderr[-4000:])
            proc.check_returncode()
            launches += sum(int(n) for n in LAUNCHES.findall(proc.stderr))
            d = json.loads(proc.stdout.splitlines()[-1])
            errs = {
                name: round(row["webrtc"] - row["truth"], 3)
                for name, row in d["per_scenario"].items()
                if row.get("webrtc") is not None
            }
            per_seed[str(seed)] = errs
            log("minutes %g seed %d: %s" % (minutes, seed, errs))
        flat = [e for errs in per_seed.values() for e in errs.values()]
        report["by_minutes"]["%g" % minutes] = {
            "per_seed": per_seed,
            "mean_s": round(sum(flat) / max(len(flat), 1), 4),
            "max_abs_s": round(max(abs(e) for e in flat), 3) if flat else None,
        }
    log("frontend kernel launches: %d" % launches)
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
