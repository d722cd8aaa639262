# -*- coding: utf-8 -*-
"""CPU tests of the benchmark: runs are driven at one minute a film on the
CPU (the port's plain versions), with 30-s pipeline chunks so that a film
has two."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"config": {"minutes": 1, "cues_per_film": 10, "pipeline_chunk_seconds": 30},
        "traffic": {"films": 2, "subtitle_files": 8, "lead_seconds": 8,
                    "offset_bound_seconds": 5, "bank_utterances": 8},
        "check": {"sample_every": 1}}


def tiny(cell):
    """Overrides that shrink ``cell`` to a size the CPU runs in seconds."""
    out = {k: dict(v) for k, v in TINY.items()}
    if cell.startswith("season10"):
        out["traffic"].update(films=3, subtitle_files=9)
        out["check"].update(jobs_per_request=2)
    return out


@pytest.fixture
def cpu_program(monkeypatch):
    """The port on the CPU, 30-s pipeline chunks."""
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "30")
