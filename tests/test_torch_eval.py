# -*- coding: utf-8 -*-
"""The port's evaluation harnesses against the JAX package's scripts: the
adversarial window-accuracy eval (``scripts/eval_neural_vad.py``), its bar
functions, and the offset-agreement harness (``scripts/eval_vad_agreement.
py``). The JAX side runs its one-launch VAD programs with Pallas in
interpret mode, as the port's parity tests do."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from ffsubsync_tpu_torch.scripts import eval_neural_vad as teval
from ffsubsync_tpu_torch.scripts import eval_vad_agreement as tagree

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
BACKENDS = ["silero", "fused", "webrtc", "auditok"]
CONDITIONS = ["low_snr_pink", "plucked_music"]  # one speech, one negative
ACC_TOL = 0.01
OFFSET_TOL = 0.01


def _load(script):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.splitext(script)[0], os.path.join(SCRIPTS, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def jax_scripts():
    return _load("eval_neural_vad.py"), _load("eval_vad_agreement.py")


def test_adversarial_eval_matches_reference(jax_scripts):
    """Per condition and backend, the port's window accuracy within 0.01 of
    the reference harness's: one 5-s clip at 12 kHz per condition."""
    jeval, _ = jax_scripts
    want = jeval.evaluate(BACKENDS, 1, 5.0, 12000, 0, conditions=CONDITIONS)
    got = teval.evaluate(BACKENDS, 1, 5.0, 12000, 0, conditions=CONDITIONS,
                         device=torch.device("cpu"))
    assert sorted(got) == sorted(want) == sorted(CONDITIONS)
    for name in CONDITIONS:
        for backend in BACKENDS:
            assert abs(got[name][backend] - want[name][backend]) <= ACC_TOL, (
                name, backend, got[name][backend], want[name][backend])


RESULTS = [
    {"crowd_babble": {"silero": 0.78}, "plucked_music": {"silero": 0.95}},
    {"crowd_babble": {"silero": 0.78}, "plucked_music": {"silero": 0.85}},
    {"applause": {"silero": 1.0, "webrtc": 0.95}, "plucked_music": {"silero": 0.95}},
    {"applause": {"silero": 1.0, "webrtc": 0.3}, "plucked_music": {"silero": 0.95}},
    {"applause": {"silero": 1.0}, "plucked_music": {"silero": 0.95}},
    {"whisper": {"silero": 0.912, "fused": 0.8, "webrtc": 0.5, "auditok": 0.4},
     "clipped": {"silero": 0.899, "fused": 0.99, "webrtc": 0.97, "auditok": 0.98}},
]


@pytest.mark.parametrize("results", RESULTS, ids=range(len(RESULTS)))
def test_bar_functions_equal_reference(jax_scripts, results):
    jeval, _ = jax_scripts
    assert teval.gate_verdict(results) == jeval.gate_verdict(results)
    backends = sorted({b for row in results.values() for b in row})
    complete = {c: row for c, row in results.items() if all(b in row for b in backends)}
    assert teval.render_table(complete, backends) == jeval.render_table(complete, backends)
    for name in ("ACCURACY_BAR", "END_TO_END_BOUND_CONDITIONS", "WEBRTC_WINDOW_BARS"):
        assert getattr(teval, name) == getattr(jeval, name)


REPORTS = [
    {"clean": {"truth": 1.95, "fused": 1.95, "silero": 1.951, "webrtc": 1.9},
     "music_bed": {"truth": -3.05, "fused": -3.05, "silero": -3.05, "webrtc": -3.045}},
    {"clean": {"truth": 1.80, "fused": 1.82, "silero": 1.80}},
    {"noisy": {"truth": 1.80, "fused": 1.83, "silero": 1.77}},
    {"noisy": {"truth": 1.80, "silero": 1.76}},
    {"noisy_10min": {"truth": 1.80, "fused": 1.80, "silero": 1.78}},
    {"clean": {"truth": 1.80, "fused": 1.80, "silero": 1.79}},
    {"music_bed": {"truth": -3.05, "webrtc": -3.30}},
    {"laughter_breaks": {"truth": -2.50, "webrtc": -2.40},
     "music_bed": {"truth": -3.05, "webrtc": -3.13},
     "clean": {"truth": 1.00, "webrtc": 1.30}},
    {"music_bed_10min": {"truth": 1.00, "webrtc": 1.12},
     "vocals_bed_10min": {"truth": 2.00, "webrtc": 2.18},
     "strings_bed": {"truth": 3.00, "webrtc": 3.18}},
    {"clean": {"truth": 0.0, "fused": None, "webrtc": None}},
]


@pytest.mark.parametrize("rows", REPORTS, ids=range(len(REPORTS)))
@pytest.mark.parametrize("rate", [12000, 8000])
def test_check_bars_equals_reference(jax_scripts, rows, rate):
    _, jagree = jax_scripts
    report = {"mode": "synthetic", "per_scenario": rows}
    assert tagree.check_bars(report, rate) == jagree.check_bars(report, rate)


def test_scenario_slots_equal_reference(jax_scripts):
    _, jagree = jax_scripts
    assert tagree.all_scenarios() == jagree.all_scenarios()
    assert tagree.LENGTH_VARIANTS == jagree.LENGTH_VARIANTS


def test_agreement_harness_matches_reference(jax_scripts):
    """One minute of the ``clean`` movie slot synced with ``--vad fused`` by
    both harnesses: the same truth draw, offsets within 0.01 s."""
    _, jagree = jax_scripts
    want = jagree.run_synthetic(["fused"], 1.0, 12000, 0, scenarios=["clean"])
    got = tagree.run_synthetic(["fused"], 1.0, 12000, 0, scenarios=["clean"])
    assert list(got["per_scenario"]) == ["clean"]
    g, w = got["per_scenario"]["clean"], want["per_scenario"]["clean"]
    assert g["truth"] == w["truth"]
    assert g["fused"] is not None and abs(g["fused"] - w["fused"]) <= OFFSET_TOL, (g, w)
    assert abs(g["fused"] - g["truth"]) <= 0.15


def test_cli_rejects_an_unknown_condition(capsys):
    with pytest.raises(SystemExit):
        teval.main(["--conditions", "no_such_condition", "--platform", "cpu"])
    assert "unknown condition" in capsys.readouterr().err


def test_eval_cli_prints_the_verdict(capsys):
    """One condition, one short clip, the neural backend, on the CPU: the
    JSON line and the exit code of ``gate_verdict``."""
    import json

    code = teval.main(["--conditions", "plucked_music", "--clips", "1", "--seconds", "3",
                       "--frame-rate", "12000", "--backends", "silero", "--platform", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report["per_condition"]) == {"plucked_music"}
    assert code == teval.gate_verdict(report["per_condition"])[2]
    assert np.isfinite(report["value"])
