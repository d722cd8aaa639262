# -*- coding: utf-8 -*-
"""The port's stage diagnostics (``ffsubsync_tpu_torch/scripts/
diag_breakdown``, ``diag_chunks``) against the JAX package's
(``scripts/diag_breakdown.py``, ``scripts/diag_chunks.py``) on the CPU:
each script's deterministic lines, every timed label with its count of
runs, the sweep's launch counts, and in-process the stages' staged bytes,
fused labels and search result on the same PCM; the guards."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ffsubsync_tpu.ops import vad as jvad
from ffsubsync_tpu.ops.align import align_candidates as jax_align_candidates
from ffsubsync_tpu.ops.features import prepare_staged_input as jax_prepare_staged_input
from ffsubsync_tpu.subs.raster import RasterSpec as JaxRasterSpec
from ffsubsync_tpu_torch.ops.vad import make_detector
from ffsubsync_tpu_torch.scripts import diag_breakdown as tdiag
from ffsubsync_tpu_torch.scripts import diag_chunks as tchunks
from ffsubsync_tpu_torch.scripts.bench import make_problem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RATE = 12000
# diag_breakdown: 1.28 min in 38.4-s pipeline chunks, two chunks of 3840
# windows. The JAX package stages each chunk at its TPU bucket of window
# counts (ops/pallas/frontend.padded_window_count), the port at its true
# count; 3840 is its own bucket, so both stage the same bytes
BREAKDOWN = {"minutes": "1.28", "runs": "1", "pipeline_seconds": "38.4"}
# diag_chunks: 5.5 min, so that the 300-s setting cuts two chunks and the
# others one
CHUNKS = {"minutes": "5.5", "runs": "1", "launches": [1, 1, 1, 1, 2]}
# the reference's own device bar for labels (tests/test_tpu_smoke.py):
# continuous labels within 0.05 on >= 99.5% of windows. The search's score
# is a float32 sum over the signal: within SCORE_REL relative
LABEL_TOL, LABEL_AGREEMENT, SCORE_REL = 0.05, 0.995, 1e-4
TIMED = ("stage_host", "xfer", "vad[webrtc] pipeline (stage+xfer+compute)",
         "vad[silero] pipeline (stage+xfer+compute)",
         "vad[fused] pipeline (stage+xfer+compute)", "align", "pull")
DETERMINISTIC = (r"\d+ spans, \d+ samples \(.* MB i16\)", r"\d+ pipeline chunks of \d+ samples",
                 r"wire bytes: .* MB")
SWEEP = re.compile(r"^pipeline_seconds=(\S+) \((\d+) launches\): warm \S+ s, best \S+ s, "
                   r"all \[(.*)\]$", re.M)


def _env(extra, jax):
    env = dict(os.environ, OMP_NUM_THREADS="1", FFS_TPU_NO_XLA_CACHE="1")
    env.pop("FFS_TPU_PIPELINE_SECONDS", None)
    env.pop("FFS_TPU_PALLAS_INTERPRET", None)
    env.update(extra)
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env["FFS_TORCH_DEVICE"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


@pytest.fixture(scope="module")
def runs():
    """All four scripts as processes of their own, started together. The
    JAX diag_breakdown runs its jnp frontend path; the JAX diag_chunks runs
    its one-launch program (Pallas in interpret mode), the program the
    port's detector mirrors and the only one of the JAX package that cuts
    pipeline chunks."""
    breakdown_argv = [BREAKDOWN["minutes"], BREAKDOWN["runs"]]
    breakdown_env = {"FFS_TPU_PIPELINE_SECONDS": BREAKDOWN["pipeline_seconds"]}
    chunks_argv = [CHUNKS["minutes"], CHUNKS["runs"]]
    cmds = {
        ("jax", "breakdown"): ([sys.executable, "scripts/diag_breakdown.py"] + breakdown_argv,
                               _env(breakdown_env, jax=True)),
        ("jax", "chunks"): ([sys.executable, "scripts/diag_chunks.py"] + chunks_argv,
                            _env({"FFS_TPU_PALLAS_INTERPRET": "1"}, jax=True)),
        ("port", "breakdown"): ([sys.executable, "-m", "ffsubsync_tpu_torch.scripts.diag_breakdown"]
                                + breakdown_argv, _env(breakdown_env, jax=False)),
        ("port", "chunks"): ([sys.executable, "-m", "ffsubsync_tpu_torch.scripts.diag_chunks"]
                             + chunks_argv, _env({}, jax=False)),
    }
    procs = {key: subprocess.Popen(cmd, cwd=REPO, text=True, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, env=env)
             for key, (cmd, env) in cmds.items()}
    out = {}
    try:
        for key, proc in procs.items():
            _stdout, err = proc.communicate(timeout=180)
            assert proc.returncode == 0, (key, err[-3000:])
            out[key] = err
    finally:
        for proc in procs.values():
            proc.kill()
    return out


def _lines(err):
    return [line for line in err.splitlines() if line.strip()]


def test_breakdown_prints_the_jax_scripts_lines(runs):
    """The problem's, the chunks' and the wire bytes' lines word for word;
    every timed stage with one time per run."""
    theirs, ours = _lines(runs["jax", "breakdown"]), _lines(runs["port", "breakdown"])
    for pattern in DETERMINISTIC:
        want = [line for line in theirs if re.fullmatch(pattern, line)]
        assert len(want) == 1, (pattern, theirs)
        assert [line for line in ours if re.fullmatch(pattern, line)] == want
    assert "2 pipeline chunks of %d samples" % (3840 * 120) in ours
    for label in TIMED:
        for lines in (theirs, ours):
            (line,) = [x for x in lines if x.startswith(label + " ")]
            times = re.search(r"all \[(.*?)\]", line).group(1).split(",")
            assert len(times) == int(BREAKDOWN["runs"]), line
            assert all(np.isfinite(float(t)) for t in times), line
    assert ours[0] == "device: cpu | analysis rate %d" % RATE
    # the plain path on the CPU launches no kernel
    assert ours[-1] == "frontend kernel launches: 0"


def test_chunks_sweeps_the_jax_scripts_settings(runs):
    """The same settings with the same launch counts, one time per run."""
    theirs = SWEEP.findall(runs["jax", "chunks"])
    ours = SWEEP.findall(runs["port", "chunks"])
    assert [(s, int(n)) for s, n, _all in ours] == [(s, int(n)) for s, n, _all in theirs]
    assert [s for s, _n, _all in ours] == list(tchunks.SETTINGS)
    assert [int(n) for _s, n, _all in ours] == CHUNKS["launches"]
    assert all(len(times.split(",")) == int(CHUNKS["runs"]) for _s, _n, times in ours)
    lines = _lines(runs["port", "chunks"])
    assert lines[0] == "device: cpu" and lines[-1] == "frontend kernel launches: 0"


# --------------------------------------------------------------------------
# the stages in-process, against the JAX modules on the same PCM
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    return make_problem(float(BREAKDOWN["minutes"]), RATE)


@pytest.fixture
def _chunked(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", BREAKDOWN["pipeline_seconds"])
    # the JAX package's one-launch program (Pallas in interpret mode)
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FFS_TPU_NO_XLA_CACHE", "1")


def test_staged_bytes_equal_the_jax_staging(problem, _chunked):
    pcm = problem[0]
    chunks = tdiag.pipeline_chunks(pcm, RATE)
    assert [len(c) for c in chunks] == [3840 * 120] * 2
    staged = tdiag.stage_host(chunks, RATE)
    for (framed, rate, window, n_windows), chunk in zip(staged, chunks):
        want, _mats, want_n = jax_prepare_staged_input(chunk, RATE, 100)
        assert (rate, window, n_windows) == (RATE, 120, want_n)
        assert framed.dtype == want.dtype and framed.shape == want.shape
        assert framed.tobytes() == want.tobytes()
    bufs = tdiag.xfer(staged, CPU)
    for buf, (framed, _r, _w, _n) in zip(bufs, staged):
        assert buf.device == CPU and np.array_equal(buf.numpy(), framed)


def test_fused_labels_and_search_match_the_jax_package(problem, _chunked):
    """The vad stage's fused labels, chunked as the pipeline chunks them,
    against the JAX package's; the align stage's pick against the JAX
    search on the JAX labels; the pull stage's labels are the signal's."""
    pcm, _spans, _sub, candidates, _ratios = problem
    signal = tdiag.vad(make_detector("fused", 100, RATE, 0.0, CPU), pcm, CPU)
    det = jvad.make_detector("fused", 100, RATE, 0.0)
    theirs = det.gather([det.dispatch_async(pcm)])
    assert len(signal._parts) == len(theirs._parts) == 2
    labels, seconds = tdiag.pull(signal)
    want = np.asarray(theirs.materialize())
    assert labels.shape == want.shape == (7680,) and seconds >= 0.0
    assert np.isfinite(labels).all()
    assert np.mean(np.abs(labels - want) < LABEL_TOL) >= LABEL_AGREEMENT

    ours = tdiag.align(signal, candidates)
    jax_candidates = [JaxRasterSpec(n_samples=s.n_samples, starts=s.starts, ends=s.ends,
                                    weight=s.weight, max_time=s.max_time,
                                    sample_rate=s.sample_rate) for s in candidates]
    reference = jax_align_candidates(theirs, jax_candidates, max_offset_samples=6000)
    best = max(range(len(ours)), key=lambda i: ours[i].score)
    assert best == max(range(len(reference)), key=lambda i: reference[i].score) == 0
    assert ours[best].offset == reference[best].offset == 734  # 7.34 s
    assert ours[best].score == pytest.approx(reference[best].score, rel=SCORE_REL)


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------

MAINS = {"diag_breakdown": tdiag.main, "diag_chunks": tchunks.main}


@pytest.mark.parametrize("script", sorted(MAINS))
def test_zero_runs_raise_a_value_error(script, monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    with pytest.raises(ValueError, match="runs=0"):
        MAINS[script](["1", "0"])


@pytest.mark.parametrize("script", sorted(MAINS))
def test_no_card_raises_instead_of_the_cpu(script, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cuda"):
        MAINS[script](["1", "1"])


@pytest.mark.parametrize("before", [None, "123"])
def test_chunks_puts_the_pipeline_variable_back(before, monkeypatch, capsys):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    if before is None:
        monkeypatch.delenv(tchunks.PIPELINE_ENV, raising=False)
    else:
        monkeypatch.setenv(tchunks.PIPELINE_ENV, before)
    assert tchunks.main(["0.5", "1"]) == 0
    assert os.environ.get(tchunks.PIPELINE_ENV) == before
    assert [int(n) for _s, n, _t in SWEEP.findall(capsys.readouterr().err)] == [1] * 5
