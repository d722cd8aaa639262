#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Time the frontend kernel of two checkouts of this repository in turns.

    python3 frontend_ab.py OLD_CHECKOUT [NEW_CHECKOUT]   # NEW defaults to .

Run on a machine with a CUDA card and nvcc; unpack the older commit with
``git archive`` into a directory ``.gitignore`` lists (``build/``). Each
turn, old, new, new, old, is a process of its own that imports
``ffsubsync_tpu_torch.ops.frontend`` from its checkout (which builds that
checkout's kernels into its own ``build/``), holds ``fused_frontend``
against ``frontend_plain`` at the 45-minute chunk under ``chip_smoke.TOLS``,
and times the kernel at every path's launch shape (``chip_smoke.
PATH_WINDOWS``; CUDA events, ``chip_smoke.KERNEL_CALLS`` calls back to
back per sample, median of 15). The input is seeded 12 kHz mu-law int8
codes ``[T, 120]``, the main path's wire; both versions read the same
codes. The last line of standard output is one JSON object with every
turn's times.
"""
import json
import os
import subprocess
import sys

WINDOW, RATE = 120, 12000


def turn(checkout):
    """One turn in this process: check, then time, the checkout's kernel."""
    import numpy as np
    import torch

    from chip_smoke import KERNEL_CALLS, PATH_WINDOWS, TOLS, median_ms

    sys.path.insert(0, os.path.abspath(checkout))
    from ffsubsync_tpu_torch.ops import frontend as fe

    rng = np.random.RandomState(0)
    codes = rng.randint(-127, 128, size=(max(PATH_WINDOWS.values()), WINDOW)).astype(np.int8)
    ms, errs = {}, {}
    for label, windows in PATH_WINDOWS.items():
        x = torch.from_numpy(codes[:windows]).to("cuda")
        if label == "fused":
            got = fe.fused_frontend(x, WINDOW, RATE)
            for (name, (rtol, atol)), a, b in zip(TOLS.items(), got,
                                                  fe.frontend_plain(x, WINDOW, RATE)):
                err = (a - b).abs()
                if not torch.isfinite(a).all() or (err > atol + rtol * b.abs()).any():
                    sys.exit("%s: %s out of tolerance" % (checkout, name))
                errs[name] = float(err.max())
        ms[label] = median_ms(lambda: fe.fused_frontend(x, WINDOW, RATE), calls=KERNEL_CALLS)
    print(json.dumps({"checkout": checkout, "source": fe.__file__, "ms": ms,
                      "max_abs_err": errs}))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
        return
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    old, new = sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else "."
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for who, checkout in (("old", old), ("new", new), ("new", new), ("old", old)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", checkout],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit("turn %s (%s) failed:\n%s%s" % (who, checkout, proc.stdout, proc.stderr))
        turns.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]), who=who))
        print("%s %s: %s" % (who, checkout, turns[-1]), flush=True)
    for label in turns[0]["ms"]:
        print("%-8s %s ms" % (label, " / ".join("%s %.4f" % (t["who"], t["ms"][label])
                                                for t in turns)))
    print(json.dumps({"device": smi, "turns": turns}))


if __name__ == "__main__":
    main()
