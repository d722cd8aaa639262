#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Where one launch of the scan kernel spends its time, phase by phase.

    python3 scan_phases.py        # on a machine with a CUDA card and nvcc

Builds ``ffsubsync_tpu_torch/csrc/scan.cu`` once more with
``-DFFS_SCAN_PHASES`` into ``build/scan_phases/`` (a library of its own,
which the port never loads): thread 0 of every block then stamps
``clock64()`` as the block enters and as each phase of ``scan_one_pass``
ends: the tile claim, the load, the local scan, the look-back (at 2 and 6
columns the local values go into shared memory first) and the store (tile
prefix o local value on the way out). It launches that build at the
webrtc detector's scan shapes of a 45-minute chunk (270,000 windows, 66
tiles) and of a 60-s segment (6,000 windows, 2 tiles), on inputs made from
a seed, checks each output against the port's own launch bit for bit, and
prints one JSON line per scan: the mean and largest cycles of each phase
over the tiles (means over ``RUNS`` launches), and the nanoseconds from the
first block's entry to the last block's exit (the global timer). Then the
card's ``nvidia-smi`` line.
"""
import ctypes
import json
import os
import subprocess
import sys

RUNS = 5
PHASES = ("claim", "load", "scan", "look_back", "store")
HERE = os.path.dirname(os.path.abspath(__file__))
# (name, op code of ops/scan._OPS, reverse, dtype, row count past T, columns)
SCANS = (("affine", 5, False, "float32", 0, 6), ("min", 1, False, "float32", 0, 6),
         ("add", 0, False, "float32", 60, 2), ("add", 0, False, "float32", 85, 2),
         ("max", 4, False, "int32", 0, 1), ("min_reverse", 3, True, "int32", 0, 1))
WINDOWS = {"45-min chunk": 270000, "60-s segment": 6000}


def build():
    from ffsubsync_tpu_torch.ops import _build

    out_dir = os.path.join(HERE, "build", "scan_phases")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libscan_phases.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-DFFS_SCAN_PHASES", "-shared", "-o", lib,
                    os.path.join(_build.CSRC_DIR, "scan.cu")], check=True)
    lib = ctypes.CDLL(lib)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ffs_scan_launch.argtypes = [i32, i32, i32, i64, i32] + [ptr] * 5 + [i32, i32, ptr]
    lib.ffs_scan_workspace_words.argtypes = [i32]
    lib.ffs_scan_workspace_words.restype = i64
    lib.ffs_scan_phases.argtypes = [ptr]
    return lib


def main():
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.ops import scan

    if not torch.cuda.is_available():
        sys.exit("scan_phases.py: no CUDA card")
    lib = build()
    dev = torch.device("cuda", 0)
    cap = 256
    ws = torch.zeros(lib.ffs_scan_workspace_words(cap), dtype=torch.int32, device=dev)
    stamps = np.zeros((lib.ffs_scan_phase_tiles(), 8), np.int64)
    rng = np.random.RandomState(0)
    epoch = 0
    for where, t in WINDOWS.items():
        for name, code, reverse, dtype, extra, cols in SCANS:
            n = t + extra
            shape = (n,) if cols == 1 else (n, cols)
            arrays = 2 if name == "affine" else 1
            if dtype == "int32":
                xs = [torch.from_numpy(rng.randint(-10 ** 6, 10 ** 6, shape).astype(np.int32))]
            else:
                xs = [torch.from_numpy((rng.randn(*shape) * 30).astype(np.float32))
                      for _ in range(arrays)]
            xs = [x.to(dev) for x in xs]
            ys = [torch.empty_like(x) for x in xs]
            tiles = -(-n // scan.TILE_ROWS)
            runs = []
            for k in range(3 + RUNS):
                epoch += 1
                ptrs = ([x.data_ptr() for x in xs] + [None])[:2] + \
                    ([y.data_ptr() for y in ys] + [None])[:2]
                status = lib.ffs_scan_launch(0, code, int(reverse), n, cols, *ptrs, ws.data_ptr(),
                                             cap, epoch, torch.cuda.current_stream(dev).cuda_stream)
                torch.cuda.synchronize()
                if status != 0 or lib.ffs_scan_phases(stamps.ctypes.data) != 0:
                    sys.exit("scan_phases.py: %s %r: cudaError %d" % (name, shape, status))
                if k >= 3:
                    s = stamps[:tiles]
                    cycles = np.diff(s[:, :6], axis=1)
                    runs.append((cycles.mean(0), cycles.max(0), s[:, 7].max() - s[:, 6].min()))
            want = (scan.affine_scan(*xs) if name == "affine"
                    else (scan.scan_cols(xs[0], name.split("_")[0], reverse),))
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(ys, want))
            if not same:
                sys.exit("scan_phases.py: %s %r: the instrumented build differs from the port's"
                         % (name, shape))
            print(json.dumps({
                "scan": name, "shape": list(shape), "dtype": dtype, "where": where, "tiles": tiles,
                "mean_cycles": dict(zip(PHASES, np.mean([r[0] for r in runs], 0).round(1).tolist())),
                "max_cycles": dict(zip(PHASES, np.mean([r[1] for r in runs], 0).round(1).tolist())),
                "ns": float(np.mean([r[2] for r in runs])),
            }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
