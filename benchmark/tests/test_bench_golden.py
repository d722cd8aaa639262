# -*- coding: utf-8 -*-
"""The check's tables of the three cells, pinned.

Each cell's first requests at the tiny sizes, every request sampled, are
attached and judged as a run attaches and judges its sample. The tables
below were read from this harness; a change that moves how a cell is
judged (a judge loaded by name, say) has to give them again. Counts and
limits compare exactly, the floating gaps at a relative 1e-12, on one
CPU thread so that no reduction's order depends on the machine's cores;
a gap of round-off alone (film90-default's search, ~1e-16, which moves
with the order of a sum) compares within 1e-14.
"""
import math
import os

import pytest
import torch

from benchmark.harness import runner, spans, spec, synth
from benchmark.tests.conftest import tiny

SEED = 2**33 + 7
# (requests, jobs judged, {number: [value, limit]})
GOLDEN = {
    "film90-default": (8, 8, {"flip_share": [0.0, 0.0001],
                              "search_gap": [1.885353859396617e-16, 0.001],
                              "cue_ms": [0.0, 0]}),
    "film90-fused": (8, 8, {"flip_share": [0.0, 0.0001],
                            "soft_gap": [0.00043309177019962286, 0.005],
                            "search_gap": [1.001112483496371e-07, 0.001],
                            "cue_ms": [0.0, 0]}),
    "season10-default": (3, 6, {"flip_share": [0.0, 0.00012],
                                "search_gap": [1.0906387155551547e-08, 0.001],
                                "cue_ms": [0.0, 0]}),
}
FLOATING = ("soft_gap", "search_gap")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(GOLDEN))
def test_the_check_gives_the_golden_table(cell, cpu_program, one_thread, tmp_path):
    n_requests, n_jobs, golden = GOLDEN[cell]
    _e, check_spec, config, traffic = spec.cell(cell)
    for part, extra in tiny(cell).items():
        {"config": config, "traffic": traffic, "check": check_spec}[part].update(extra)
    media = synth.make_media(str(tmp_path), SEED, config, traffic, torch.device("cpu"))
    os.makedirs(tmp_path / "out")
    ctx = runner.Context(media, traffic, str(tmp_path / "out"))
    entry = spec.entry(traffic["entry"])
    requests = []
    with spans.Recorder() as rec:
        for k in range(n_requests):
            rec.begin(k, bool(runner.sampled(k, SEED, int(check_spec["sample_every"]))))
            requests.append({"k": k, "jobs": entry.request(ctx, k)})
            rec.end()
    runner._attach(requests, rec, SEED, check_spec)
    jobs = runner.rec_jobs(requests)
    correct, table = runner._check(jobs, config, traffic, check_spec, torch.device("cpu"))
    assert (correct, len(jobs), sorted(table)) == (True, n_jobs, sorted(golden))
    for name, (value, limit) in golden.items():
        got, got_limit = table[name]
        assert got_limit == limit, name
        if name in FLOATING:
            assert math.isclose(got, value, rel_tol=1e-12, abs_tol=1e-14), (name, got, value)
        else:
            assert got == value, (name, got, value)
