#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The benchmark of ffsubsync_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the repository's root and prints
its result as one JSON line, last on standard output. ``--trace 1`` runs the
same window under ``torch.profiler`` and reports the cell's per-layer
metrics instead of its end-to-end ones. Every build and kernel cache lives
under ``build/`` in the checkout, at fixed paths.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root: the program and the benchmark package

for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
os.environ["USE_FLAX"] = "0"

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
