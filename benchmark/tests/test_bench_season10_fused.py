# -*- coding: utf-8 -*-
"""The cell ``season10-fused`` (a batch of films synced with ``--vad
fused``) on the CPU at the tiny sizes: the plain reference agrees with the
port, the control reads incorrect, a planted fault reads incorrect, and the
net's two readers, ``net_ms`` and ``net_loads_per_request``, on a synthetic
span list and on a traced run."""
import os

import numpy as np
import pytest

from benchmark.harness import program_spans, runner, spec
from benchmark.harness.runner import Run
from benchmark.readings import readings
from benchmark.tests.conftest import tiny
from ffsubsync_tpu_torch.utils.tracing import Span

CELL = "season10-fused"


def test_the_cell_runs_the_fused_batch():
    entry, _check, config, traffic = spec.cell(CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("season10_fused", "batch10_fused", 1)
    assert traffic["entry"] == "batch_sync" and traffic["kwargs"] == {"vad": "fused"}
    assert traffic["vad_mode"] == "weighted" and "net" in traffic["work"]
    default = spec.traffic("batch10_default")
    assert {k: v for k, v in traffic.items() if k not in ("kwargs", "vad_mode", "work")} == {
        k: v for k, v in default.items() if k not in ("kwargs", "vad_mode", "work")}
    assert os.path.exists(os.path.join(spec.ROOT, config["weights"]))


def test_the_configuration_is_the_season_at_its_published_size():
    # the fused season is its own deployment, with the default season's
    # numbers and weights: nothing is cut
    config, season = spec.config("season10_fused"), spec.config("season10")
    assert config["reduced"] == [] and config["source"] != season["source"]
    numbers = [k for k, v in season.items() if isinstance(v, (int, float, list)) and k != "assumed"]
    assert {k: config[k] for k in numbers} == {k: season[k] for k in numbers}
    assert config["weights"] == season["weights"] and config["assumed"] == season["assumed"]


def test_the_reference_agrees_with_the_port_on_the_cpu(cpu_program):
    row = readings(CELL, [2**31 + 99], set(), 3, require_cuda=False, overrides=tiny(CELL),
                   log=lambda _line: None)[2**31 + 99]
    assert row["judged"] == row["jobs"] > 0
    got = row["program"]
    # the bounds of test_bench_reference.py: no hard decision flips, the
    # net's probabilities within 2e-3, the best answer with its exact
    # score, the cues exact
    assert got["flip_share"] == 0
    assert got["soft_gap"] <= 2e-3
    assert got["search_gap"] <= 1e-6
    assert got["cue_ms"] == 0


def test_the_control_reads_incorrect(cpu_program):
    row = readings(CELL, [2**31 + 3], {2**31 + 3}, 2, require_cuda=False, overrides=tiny(CELL),
                   log=lambda _line: None)[2**31 + 3]
    limits = spec.workload(CELL)["limits"]
    failed = [k for k, limit in limits.items() if row["control"][k] > limit]
    assert failed, (row["control"], limits)


def test_labels_shifted_by_one_window_in_one_job_read_incorrect(cpu_program, monkeypatch):
    """The first film's labels move one 10-ms window later where its source
    produces them; every job of a request is judged, so each request judges
    the film."""
    from ffsubsync_tpu_torch.media import audio
    from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal

    real = audio.VideoSpeechSource._fit_using_audio

    def shifted(self, fname):
        real(self, fname)
        if os.path.basename(fname) == "film0.wav":
            v = np.asarray(self.video_speech_results_, np.float64)
            self.video_speech_results_ = LazySpeechSignal.from_host(
                np.concatenate([v[:1], v[:-1]]), self.video_speech_results_.device)

    monkeypatch.setattr(audio.VideoSpeechSource, "_fit_using_audio", shifted)
    overrides = tiny(CELL)
    overrides["check"]["jobs_per_request"] = 0  # all of them
    line, rc = runner.run(CELL, 2**32 + 17, 1.0, False, require_cuda=False, overrides=overrides)
    assert rc == 0
    assert line["correct"] is False
    assert line["check"]["flip_share"]["value"] > line["check"]["flip_share"]["limit"]


def _s(name, i, parent, request, t0, t1, tid=1):
    return Span(name, i, parent, request, tid, t0, t1)


# two batches of one second each: the first with two jobs whose extracts
# run at once on threads 2 and 3, each loading the net and calling it on
# two chunks; the second with one job on thread 2
SPANS = [
    _s("batch", 1, None, 1, 0.10, 0.90),
    _s("extract", 2, 1, 1, 0.10, 0.50, tid=2),
    _s("extract", 3, 1, 1, 0.12, 0.60, tid=3),
    _s("detector", 4, 2, 1, 0.10, 0.20, tid=2),
    _s("net_load", 5, 4, 1, 0.11, 0.19, tid=2),
    _s("detector", 6, 3, 1, 0.12, 0.25, tid=3),
    _s("net_load", 7, 6, 1, 0.13, 0.24, tid=3),
    _s("vad_program", 8, 2, 1, 0.30, 0.35, tid=2),
    _s("net", 9, 8, 1, 0.31, 0.33, tid=2),
    _s("vad_program", 10, 2, 1, 0.35, 0.40, tid=2),
    _s("net", 11, 10, 1, 0.36, 0.38, tid=2),
    _s("vad_program", 12, 3, 1, 0.30, 0.36, tid=3),
    _s("net", 13, 12, 1, 0.31, 0.34, tid=3),
    _s("vad_program", 14, 3, 1, 0.40, 0.46, tid=3),
    _s("net", 15, 14, 1, 0.41, 0.44, tid=3),
    _s("batch", 20, None, 20, 1.10, 1.90),
    _s("extract", 21, 20, 20, 1.10, 1.50, tid=2),
    _s("detector", 22, 21, 20, 1.10, 1.20, tid=2),
    _s("net_load", 23, 22, 20, 1.11, 1.16, tid=2),
    _s("vad_program", 24, 21, 20, 1.30, 1.40, tid=2),
    _s("net", 25, 24, 20, 1.31, 1.35, tid=2),
    # a batch outside every request (the warm-up), and a span of no request
    _s("batch", 30, None, 30, 2.10, 2.20),
    _s("net", 31, 30, 30, 2.10, 2.15),
    _s("net_load", 40, None, None, 0.70, 0.75),
]


def _run():
    return Run(requests=[{"k": 0, "t0": 0.0, "t1": 1.0, "jobs": [{}, {}]},
                         {"k": 1, "t0": 1.0, "t1": 2.0, "jobs": [{}]}],
               spans=[], programs=[], counters={}, trace=None, config={}, traffic={},
               window_s=2.0)


def read(name, run):
    return spec.metric_reader(name).read(run)


@pytest.mark.parametrize("name, want", [
    ("net_ms", ((20 + 20 + 30 + 30) + 40) / 2),  # summed over the two threads
    ("net_loads_per_request", (2 + 1) / 2),  # the span of no request is left out
])
def test_each_reader_on_a_span_list(monkeypatch, name, want):
    monkeypatch.setattr(program_spans, "_program_spans", lambda: list(SPANS))
    assert read(name, _run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["net_ms", "net_loads_per_request"])
def test_a_program_without_spans_reports_nothing(monkeypatch, name):
    for spans in (None, [], [_s("batch", 30, None, 30, 2.10, 2.20)]):
        monkeypatch.setattr(program_spans, "_program_spans", lambda spans=spans: spans)
        assert read(name, _run()) is None, spans


def test_a_traced_run_reports_a_net_load_a_film(cpu_program):
    """Every job of a batch builds its detector and loads the net: three
    films at the tiny size."""
    line, rc = runner.run(CELL, 7, 1.0, True, require_cuda=False, overrides=tiny(CELL))
    assert rc == 0 and line["correct"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["net_loads_per_request"] == 3
    assert 0 < metrics["net_ms"] < metrics["vad_issue_ms"]
