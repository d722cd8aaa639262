# -*- coding: utf-8 -*-
"""The plain reference against the port's CPU path, and what each side
imports.

The reference (``benchmark/reference``) imports nothing of the program or
of JAX; the harness imports no JAX. Both checks compare top-level module
names whole, since the port's own name begins with the JAX package's.
"""
import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import runner, spec
from benchmark.tests.conftest import ROOT, tiny

JAX = {"jax", "jaxlib", "flax", "optax", "ffsubsync_tpu"}
PROGRAM = {"ffsubsync_tpu_torch"}


def _imported_top_levels(folder):
    names = set()
    for dirpath, _dirs, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        names |= {a.name.split(".")[0] for a in node.names}
                    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                        names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_neither_the_program_nor_jax():
    assert not _imported_top_levels(os.path.join(spec.BENCH_DIR, "reference")) & (JAX | PROGRAM)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.pipeline, benchmark.reference.search, "
            "benchmark.harness.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert not set(eval(out)) & (JAX | PROGRAM)


def test_the_harness_imports_no_jax():
    assert not _imported_top_levels(spec.BENCH_DIR) & JAX
    assert runner.forbidden_modules(["jax.numpy", "ffsubsync_tpu.sync"]) == ["ffsubsync_tpu", "jax"]
    assert runner.forbidden_modules(["ffsubsync_tpu_torch.sync", "jaxtyping"]) == []


def test_a_run_loads_no_jax(tmp_path):
    code = ("import os, sys, json; sys.path.insert(0, %r)\n"
            "os.environ['FFS_TORCH_DEVICE'] = 'cpu'; os.environ['FFS_TPU_PIPELINE_SECONDS'] = '30'\n"
            "from benchmark.harness import runner\n"
            "from benchmark.tests.conftest import tiny\n"
            "line, rc = runner.run('film90-fused', 7, 1.0, False, require_cuda=False,"
            " overrides=tiny('film90-fused'))\n"
            "print(json.dumps([rc, line['correct'], sorted({m.split('.')[0] for m in sys.modules})]))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, TMPDIR=str(tmp_path))).stdout
    import json

    rc, correct, modules = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and correct
    assert not set(modules) & JAX and "ffsubsync_tpu_torch" in modules


@pytest.mark.parametrize("cell", ["film90-default", "film90-fused", "season10-default"])
def test_the_reference_agrees_with_the_port_on_the_cpu(cell, cpu_program):
    from benchmark.readings import readings

    row = readings(cell, [2**31 + 99], set(), 3, require_cuda=False, overrides=tiny(cell),
                   log=lambda _line: None)[2**31 + 99]
    assert row["judged"] == row["jobs"] > 0
    got = row["program"]
    # the port's plain float32 path against the float64 reference, two
    # 30-s chunks of one minute each: no hard decision flips, the net's
    # probabilities within 2e-3, the answer the best one with its exact
    # score, the cues exact
    assert got["flip_share"] == 0
    assert got["soft_gap"] <= 2e-3
    assert got["search_gap"] <= 1e-6
    assert got["cue_ms"] == 0
