# -*- coding: utf-8 -*-
"""The port's benchmark scripts (``ffsubsync_tpu_torch/scripts/bench``,
``bench_batch``, ``bench_suite``) against the JAX package's (root
``bench.py``, ``scripts/bench_batch.py``, ``scripts/bench_suite.py``) at a
small size on the CPU: the JSON schema, the offsets, the synthetic
problem's bytes, the batch's per-episode offsets and each suite case's
result dict, and the guards on the knobs."""
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ffsubsync_tpu.cli import make_parser as jax_make_parser
from ffsubsync_tpu.constants import FRAMERATE_RATIOS, SAMPLE_RATE
from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu.ops.features import analysis_rate as jax_analysis_rate
from ffsubsync_tpu.parallel.batch import BatchAligner as JaxBatchAligner
from ffsubsync_tpu.subs.raster import RasterSpec as JaxRasterSpec
from ffsubsync_tpu.sync import run as jax_run
from ffsubsync_tpu_torch.ops.features import analysis_rate
from ffsubsync_tpu_torch.parallel.batch import BatchAligner
from ffsubsync_tpu_torch.scripts import bench as tbench
from ffsubsync_tpu_torch.scripts import bench_batch as tbatch
from ffsubsync_tpu_torch.scripts import bench_suite as tsuite

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHES = re.compile(r"^frontend kernel launches: (\d+)$", re.M)
# the headline bench at 2 minutes, one run of each kind
BENCH_ENV = {"BENCH_PLATFORM": "cpu", "BENCH_MINUTES": "2", "BENCH_RUNS": "1",
             "BENCH_MAX_RUNS": "1", "BENCH_VAD_RUNS": "1"}
BATCH_ENV = {"BENCH_PLATFORM": "cpu", "BENCH_EPISODES": "3", "BENCH_MINUTES": "3",
             "BENCH_RUNS": "1"}
# the suite's cases, small: (case, its size arguments); multiseg's three
# 60 s segments of a 4-min WAV are disjoint (ROADMAP C8)
SUITE_CASES = {"srt_srt": (5.0,), "wav5_energy": (1.0,), "multiseg": (4.0, 3)}


def _load(path):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.splitext(os.path.basename(path))[0], os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("FFS_TPU_PALLAS_INTERPRET", None)  # bench.py runs as it is run
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    # the reference's one-launch VAD program (Pallas in interpret mode),
    # which the port's _vad_program mirrors
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FFS_TPU_NO_XLA_CACHE", "1")


def _line(out):
    return json.loads(out.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# bench
# --------------------------------------------------------------------------

def test_bench_matches_the_jax_script():
    """Both headline benches at 2 minutes, each a process of its own, run
    side by side: the same keys (the port adds ``device``), metric, timing,
    breakdown keys, launches per sync and offsets."""
    jax_proc = subprocess.Popen(
        [sys.executable, "bench.py"], cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=_env(dict(BENCH_ENV, JAX_PLATFORMS="cpu")))
    try:
        port = subprocess.run(
            [sys.executable, "-m", "ffsubsync_tpu_torch.scripts.bench"], cwd=REPO, text=True,
            capture_output=True, env=_env(BENCH_ENV), timeout=120)
        jax_out, jax_err = jax_proc.communicate(timeout=120)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, jax_err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    theirs, ours = _line(jax_out), _line(port.stdout)
    assert set(ours) == set(theirs) | {"device"}
    for key in ("metric", "unit", "timing", "offset_err_ms", "e2e_offset_err_ms"):
        assert ours[key] == theirs[key], key
    assert theirs["offset_err_ms"] == theirs["e2e_offset_err_ms"] == 0.0
    assert set(ours["breakdown"]) == set(theirs["breakdown"])
    assert ours["breakdown"]["n_launches"] == theirs["breakdown"]["n_launches"] == 1
    assert (ours["platform"], ours["device"], theirs["platform"]) == ("cpu", None, "cpu")
    assert all(np.isfinite(ours[k]) and ours[k] > 0 for k in ("best_s", "median_s", "e2e_cli_s"))
    # the plain path on the CPU launches no kernel
    assert LAUNCHES.findall(port.stderr) == ["0"]


def test_make_problem_equals_the_jax_recipe():
    """``make_problem``'s PCM and candidates, byte for byte, against
    ``bench.py``'s recipe replayed through the JAX package."""
    frame_rate = analysis_rate(48000, SAMPLE_RATE)
    assert frame_rate == jax_analysis_rate(48000, SAMPLE_RATE) == 12000
    pcm, spans, sub_spans, candidates, ratios = tbench.make_problem(2.0, frame_rate)

    duration = 120.0
    rng = np.random.RandomState(0)
    want_spans = []
    t = 2.0
    while t < duration - 6.0:
        length = rng.uniform(1.0, 4.0)
        want_spans.append((t, t + length))
        t += length + rng.uniform(0.8, 4.0)
    wav = speech_signal_for_spans(duration, want_spans, frame_rate, speech_level=0.35)
    want_pcm = np.clip(wav * 32767, -32768, 32767).astype(np.int16)
    assert spans == want_spans
    assert pcm.dtype == want_pcm.dtype and pcm.tobytes() == want_pcm.tobytes()

    want_ratios = [1.0] + FRAMERATE_RATIOS + [1.0 / r for r in FRAMERATE_RATIOS]
    want_sub = [(a - 7.34, b - 7.34) for a, b in want_spans]
    assert ratios == want_ratios and sub_spans == want_sub
    n_sub = int((max(b for _, b in want_sub)) * SAMPLE_RATE) + 2
    assert len(candidates) == len(want_ratios)
    for ratio, spec in zip(want_ratios, candidates):
        starts = np.array([int(round(a * ratio * SAMPLE_RATE)) for a, _ in want_sub], np.int32)
        ends = np.array([int(round(b * ratio * SAMPLE_RATE)) for _, b in want_sub], np.int32)
        n = int(n_sub * ratio) + 2
        keep = starts >= 0
        want = JaxRasterSpec(n_samples=n, starts=np.clip(starts[keep], 0, n),
                             ends=np.clip(ends[keep], 0, n), weight=min(1.0 / ratio, 1.0),
                             max_time=n / SAMPLE_RATE, sample_rate=SAMPLE_RATE)
        assert (spec.n_samples, spec.weight, spec.max_time, spec.sample_rate) == (
            want.n_samples, want.weight, want.max_time, want.sample_rate)
        for got, exp in ((spec.starts, want.starts), (spec.ends, want.ends)):
            assert got.dtype == exp.dtype and got.tobytes() == exp.tobytes()


# --------------------------------------------------------------------------
# bench_batch
# --------------------------------------------------------------------------

def _jax_specs(specs):
    return [JaxRasterSpec(n_samples=s.n_samples, starts=s.starts, ends=s.ends, weight=s.weight,
                          max_time=s.max_time, sample_rate=s.sample_rate) for s in specs]


def test_bench_batch_matches_the_jax_script(monkeypatch, capsys):
    """3 episodes of 3 minutes: both scripts find every offset exactly,
    with the same keys (the port adds ``platform`` and ``device``), and the
    port's best offset of each episode is the JAX ``BatchAligner``'s on the
    same references."""
    for key, value in BATCH_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(sys, "argv", ["bench_batch.py"])
    assert _load("scripts/bench_batch.py").main() == 0
    theirs = _line(capsys.readouterr().out)
    assert tbatch.main() == 0
    captured = capsys.readouterr()
    ours = _line(captured.out)
    assert set(ours) == set(theirs) | {"platform", "device"}
    assert ours["offsets_exact"] is theirs["offsets_exact"] is True
    assert (ours["metric"], ours["unit"], ours["timing"]) == (
        theirs["metric"], theirs["unit"], theirs["timing"])
    assert (ours["platform"], ours["device"]) == ("cpu", None)
    assert LAUNCHES.findall(captured.err) == ["0"]

    refs, candidates, true_offsets = tbatch.make_episodes(3, 3.0)
    max_offset = 60 * SAMPLE_RATE
    got = BatchAligner().align_batch(refs, candidates, max_offset_samples=max_offset)
    want = JaxBatchAligner().align_batch(
        refs, [_jax_specs(c) for c in candidates], max_offset_samples=max_offset)
    best = [max(r, key=lambda a: a.score).offset for r in got]
    assert best == [max(r, key=lambda a: a.score).offset for r in want] == true_offsets


@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]])
def test_bench_batch_counts_distinct_devices(mesh):
    assert tbatch.distinct_devices(BatchAligner(mesh).mesh) == 1


# --------------------------------------------------------------------------
# bench_suite
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["_spans", "_timed_runs"])
def test_suite_helper_is_a_verbatim_copy(name):
    theirs = inspect.getsource(getattr(_load("scripts/bench_suite.py"), name))
    assert inspect.getsource(getattr(tsuite, name)) == theirs


@pytest.mark.parametrize("case", sorted(SUITE_CASES))
def test_suite_case_equals_the_jax_sync(case, tmp_path):
    """One case, small: its files through the port's CLI (timed once, as
    the suite times it) and through the JAX package's ``sync.run`` give
    the same result."""
    rng = np.random.RandomState(0)
    entry, argv = getattr(tsuite, case)(rng, str(tmp_path), 1, *SUITE_CASES[case])
    ours = tsuite.cli_case(argv)
    theirs = jax_run(jax_make_parser().parse_args(argv))
    keys = ("retval", "offset_seconds", "framerate_scale_factor")
    assert [ours[k] for k in keys] == [theirs[k] for k in keys]
    assert ours["sync_was_successful"] and ours["offset_seconds"] is not None
    assert entry["offset_err_ms"] == round(ours["err_ms"], 1)
    assert set(entry) == {"best_s", "median_s", "worst_s", "offset_err_ms"}


def test_suite_report_keeps_the_jax_schema(monkeypatch, capsys):
    """The suite's line: the keys of the reference's recorded line
    (``BENCH_SUITE_r05.json``) plus ``device``, each case's too."""
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("BENCH_RUNS", "1")
    assert tsuite.main(*SUITE_CASES["srt_srt"], *SUITE_CASES["wav5_energy"],
                       *SUITE_CASES["multiseg"]) == 0
    captured = capsys.readouterr()
    ours = _line(captured.out)
    with open(os.path.join(REPO, "BENCH_SUITE_r05.json")) as f:
        theirs = json.loads(f.read())
    assert set(ours) == set(theirs) | {"device"}
    for case in SUITE_CASES:
        assert set(ours[case]) == set(theirs[case])
    assert (ours["metric"], ours["unit"], ours["timing"]) == (
        theirs["metric"], theirs["unit"], "best-of-1")
    assert (ours["platform"], ours["device"]) == ("cpu", None)
    assert LAUNCHES.findall(captured.err) == ["0"]


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------

MAINS = {"bench": tbench.main, "bench_batch": tbatch.main, "bench_suite": tsuite.main}


@pytest.mark.parametrize("script", ["bench", "bench_batch", "bench_suite"])
def test_zero_runs_raise_a_value_error(script, monkeypatch):
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("BENCH_RUNS", "0")
    with pytest.raises(ValueError, match="BENCH_RUNS=0"):
        MAINS[script]()


def test_zero_vad_runs_raise_a_value_error(monkeypatch):
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    monkeypatch.setenv("BENCH_VAD_RUNS", "0")
    with pytest.raises(ValueError, match="BENCH_VAD_RUNS=0"):
        tbench.main()


@pytest.mark.parametrize("script", ["bench", "bench_batch", "bench_suite"])
def test_unknown_platform_raises(script, monkeypatch):
    monkeypatch.setenv("BENCH_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="BENCH_PLATFORM='tpu'"):
        MAINS[script]()


@pytest.mark.parametrize("platform", [None, "cuda"])
def test_no_card_raises_instead_of_the_cpu(platform, monkeypatch):
    """Unset or ``cuda`` asks for the card, even where ``FFS_TORCH_DEVICE``
    said ``cpu``; without one the scripts raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    if platform is None:
        monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("BENCH_PLATFORM", platform)
    for main in MAINS.values():
        with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cuda"):
            main()
