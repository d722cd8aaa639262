# -*- coding: utf-8 -*-
"""A run with its timed path broken underneath reads ``correct`` false.

Each fault is planted in the port (on the CPU, at one minute a film) and
the rest of the run is driven as on the card: a detector that hands its
state back unchanged, labels altered where the program produces them, the
search's answer altered where it is produced, and, in the batch, half of
the jobs left out of the batched search (their answers taken from the
rest). The exchange between chips is no fault of these one-chip cells.
"""
import pytest

from benchmark.harness import runner
from benchmark.tests.conftest import tiny

CELLS = ["film90-default", "film90-fused", "season10-default"]


def _run(cell):
    line, rc = runner.run(cell, 2**32 + 17, 1.0, False, require_cuda=False,
                          overrides=tiny(cell))
    assert rc == 0
    print(cell, {k: v["value"] for k, v in line["check"].items()})
    return line


def _plant_program(monkeypatch, fault):
    from ffsubsync_tpu_torch.ops import vad

    real = vad._vad_program

    def program(framed, window, frame_rate, n_valid, state, *args, **kwargs):
        labels, new = real(framed, window, frame_rate, n_valid, state, *args, **kwargs)
        if fault == "state":
            return labels, state
        labels = labels.clone()
        labels[: n_valid // 2] = 1.0 - labels[: n_valid // 2]
        return labels, new

    monkeypatch.setattr(vad, "_vad_program", program)


def _plant_answer(monkeypatch):
    from ffsubsync_tpu_torch import sync
    from ffsubsync_tpu_torch.parallel.batch import BatchAligner

    real_align, real_batch = sync.align_candidates, BatchAligner.align_batch

    def moved(alignments):
        return [type(a)(a.score, a.offset + 37) for a in alignments]

    monkeypatch.setattr(sync, "align_candidates", lambda *a, **k: moved(real_align(*a, **k)))
    monkeypatch.setattr(BatchAligner, "align_batch",
                        lambda self, *a, **k: [moved(x) for x in real_batch(self, *a, **k)])


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in ("state", "labels")])
def test_a_broken_detector_reads_incorrect(cell, fault, cpu_program, monkeypatch):
    _plant_program(monkeypatch, fault)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_reads_incorrect(cell, cpu_program, monkeypatch):
    _plant_answer(monkeypatch)
    assert _run(cell)["correct"] is False


def test_half_the_batch_left_out_reads_incorrect(cpu_program, monkeypatch):
    from ffsubsync_tpu_torch.parallel.batch import BatchAligner

    real = BatchAligner.align_batch

    def half(self, refs, candidates, **kwargs):
        kept = max(1, len(refs) // 2)
        out = real(self, refs[:kept], candidates[:kept], **kwargs)
        return [out[i % kept] for i in range(len(refs))]

    monkeypatch.setattr(BatchAligner, "align_batch", half)
    assert _run("season10-default")["correct"] is False


def test_the_sound_program_reads_correct(cpu_program):
    assert _run("film90-default")["correct"] is True
