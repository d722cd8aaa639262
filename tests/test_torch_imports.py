# -*- coding: utf-8 -*-
"""ffsubsync_tpu_torch stands alone: it imports neither jax nor the JAX
package ``ffsubsync_tpu`` (not even a module of it that does without jax),
and it never falls back silently from the device it was asked for."""
import ast
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ffsubsync_tpu_torch")

torch.set_num_threads(1)

# any import of jax or of the JAX package now raises ImportError
_BLOCK = ('import sys\nsys.modules["jax"] = None\nsys.modules["optax"] = None\n'
          'sys.modules["ffsubsync_tpu"] = None\n')

_NO_JAX_SYNC = _BLOCK + r"""
import os, tempfile
import ffsubsync_tpu_torch
import ffsubsync_tpu_torch.media.segments
import ffsubsync_tpu_torch.parallel.batch
import ffsubsync_tpu_torch.parallel.vad_shard as vad_shard
import numpy as np
from ffsubsync_tpu_torch import make_parser, run
from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16


def stamp(t):
    return "00:00:%06.3f" % t


spans = [(2.0, 4.5), (6.0, 8.0), (10.5, 13.0), (15.0, 17.5)]
audio = speech_signal_for_spans(20.0, spans, 12000, speech_level=0.35)
pcm = np.clip(audio * 32767, -32768, 32767).astype(np.int16)
sharded = vad_shard.make_sharded_detector(["cpu"] * 3, "weighted", 100, 12000, 0.0)(pcm)
assert len(sharded) == 2000 and np.isfinite(np.asarray(sharded)).all()
with tempfile.TemporaryDirectory() as d:
    wav = os.path.join(d, "ref.wav")
    write_wav_i16(wav, audio, 12000)
    srt = os.path.join(d, "in.srt")
    with open(srt, "w") as f:
        for i, (a, b) in enumerate(spans):  # cues 1.25 s early
            f.write("%d\n%s --> %s\nx\n\n"
                    % (i + 1, stamp(a - 1.25).replace(".", ","), stamp(b - 1.25).replace(".", ",")))
    results = [
        run(make_parser().parse_args(
            [wav, "-i", srt, "-o", os.path.join(d, "out.srt")] + extra))
        for extra in (["--vad", "fused"], ["--vad", "auditok"],
                      ["--multi-segment-sync", "--segment-count", "1"])
    ]
    results += sync_batch([(wav, srt, os.path.join(d, "b%d.srt" % i)) for i in range(2)],
                          vad="fused")
for result in results:
    assert result["sync_was_successful"], result
    assert abs(result["offset_seconds"] - 1.25) < 0.15, result
result = results[0]
from ffsubsync_tpu_torch.scripts import eval_neural_vad, train_neural_vad
with tempfile.TemporaryDirectory() as d:
    trained = train_neural_vad.train(train_neural_vad.make_parser().parse_args(
        ["--steps", "2", "--batch", "2", "--clip-seconds", "2", "--frame-rate", "12000",
         "--out", os.path.join(d, "w.npz"), "--platform", "cpu"]))
    assert len(trained.losses) == 2 and np.isfinite(trained.losses).all()
    assert os.path.exists(trained.out)
accuracy = eval_neural_vad.evaluate(["fused"], 1, 3.0, 12000, 0, conditions=["clipped"])
assert 0.0 <= accuracy["clipped"]["fused"] <= 1.0
from ffsubsync_tpu_torch.ops.align import align_signal_pair
os.environ.pop("FFS_TPU_HOST_ALIGN", None)  # the default: the device branch, on FFS_TORCH_DEVICE
assert align_signal_pair("11001", "111001").offset == -1
import torch
from ffsubsync_tpu_torch.scripts import probe_babble_ceiling
probe = probe_babble_ceiling.train(probe_babble_ceiling.make_parser().parse_args(
    ["--steps", "2", "--batch", "1", "--clip-seconds", "1"]), torch.device("cpu"))
assert len(probe.losses) == 2 and np.isfinite(probe.losses).all()
import ffsubsync_tpu_torch.gui
from ffsubsync_tpu_torch.scripts import bench, bench_batch, bench_suite
os.environ.update(BENCH_PLATFORM="cpu", BENCH_MINUTES="1", BENCH_RUNS="1", BENCH_MAX_RUNS="1",
                  BENCH_VAD_RUNS="1", BENCH_EPISODES="2")
assert bench.main() == 0 and bench_batch.main() == 0
assert bench_suite.main(1.0, 1.0, 2.0, 2) == 0
from ffsubsync_tpu_torch.scripts import diag_breakdown, diag_chunks
from ffsubsync_tpu_torch.ops.vad import make_detector
cpu = torch.device("cpu")
pcm, _spans, _sub, candidates, _ratios = bench.make_problem(1.0, 12000)
staged = diag_breakdown.stage_host(diag_breakdown.pipeline_chunks(pcm, 12000), 12000)
assert len(diag_breakdown.xfer(staged, cpu)) == 1
signal = diag_breakdown.vad(make_detector("fused", 100, 12000, 0.0, cpu), pcm, cpu)
assert max(diag_breakdown.align(signal, candidates), key=lambda a: a.score).offset == 734
assert len(diag_breakdown.pull(signal)[0]) == 6000 and diag_chunks.SETTINGS[0] == "0"
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and m.split(".")[0] in ("jax", "optax", "ffsubsync_tpu")]
assert not loaded, loaded
print("NO_JAX_SYNC_OK", result["offset_seconds"])
"""


def test_fused_wav_sync_runs_with_jax_blocked(tmp_path):
    """The fused, auditok, multi-segment and batch syncs of a WAV, the
    sharded VAD, two training steps, one eval condition, the device branch
    of ``align_signal_pair``, two babble-probe steps, the GUI module, the
    three benchmark scripts at their smallest and ``diag_breakdown``'s
    stages at 1 minute (``diag_chunks`` imported), with jax, optax and the
    JAX package made unimportable and the fixtures taken from the port; no
    module of any of them loads."""
    env = dict(os.environ, FFS_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SYNC], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_SYNC_OK" in proc.stdout


def test_module_cli_entry_runs_with_jax_blocked(tmp_path):
    """``python -m ffsubsync_tpu_torch`` (an srt reference: host only), with
    jax and the JAX package made unimportable."""
    srt = "1\n00:00:05,000 --> 00:00:07,500\nHello.\n\n2\n00:00:12,250 --> 00:00:15,000\nThere.\n\n"
    late = srt.replace("00:00:05,000", "00:00:06,000").replace("00:00:07,500", "00:00:08,500")
    late = late.replace("00:00:12,250", "00:00:13,250").replace("00:00:15,000", "00:00:16,000")
    (tmp_path / "ref.srt").write_text(srt)
    (tmp_path / "in.srt").write_text(late)
    script = _BLOCK + (
        "import runpy\n"
        "sys.argv = ['ffs-torch', 'ref.srt', '-i', 'in.srt', '-o', 'out.srt']\n"
        "runpy.run_module('ffsubsync_tpu_torch', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "00:00:05,000 --> 00:00:07,500" in (tmp_path / "out.srt").read_text()


def _sources():
    """Every ``.py`` of the port, ``chip_smoke.py`` and ``frontend_ab.py``."""
    paths = [os.path.join(REPO, name) for name in ("chip_smoke.py", "frontend_ab.py")]
    for root, _dirs, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return paths


def _names(root, path):
    """Modules under ``root`` that ``path`` imports, or names in a string
    that ``importlib`` could be handed (a dotted module path)."""
    under = re.compile(r"%s(\.\w+)*" % re.escape(root))
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if under.fullmatch(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if under.fullmatch(node.module or ""):
                found.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if under.fullmatch(node.value):
                found.append(node.value)
    return found


@pytest.mark.parametrize("root", ["jax", "optax", "ffsubsync_tpu"])
def test_no_source_file_imports(root):
    """An AST scan: no ``import``/``from`` of ``root`` or a module under it,
    and no string naming one, in the port or in its two scripts."""
    offenders = {}
    for path in _sources():
        names = _names(root, path)
        if names:
            offenders[os.path.relpath(path, REPO)] = names
    assert not offenders


def test_scan_covers_the_diagnostics():
    """The scan walks the package, so it reads the stage diagnostics."""
    scripts = os.path.join(PKG, "scripts")
    diagnostics = {os.path.join(scripts, name) for name in ("diag_breakdown.py", "diag_chunks.py")}
    assert diagnostics <= set(_sources())


def test_scan_finds_every_import_form(tmp_path):
    """The scan itself: each form it must catch, and names it must not."""
    path = tmp_path / "probe.py"
    path.write_text(
        "import ffsubsync_tpu\n"
        "import ffsubsync_tpu.cli as c\n"
        "from ffsubsync_tpu.subs import raster\n"
        "from ffsubsync_tpu import native\n"
        "import importlib\n"
        "importlib.import_module('ffsubsync_tpu.sync')\n"
        "import ffsubsync_tpu_torch\n"
        "from ffsubsync_tpu_torch import native\n"
        "x = 'ffsubsync_tpu/ops/align.py'\n"
    )
    assert _names("ffsubsync_tpu", str(path)) == [
        "ffsubsync_tpu", "ffsubsync_tpu.cli", "ffsubsync_tpu.subs", "ffsubsync_tpu",
        "ffsubsync_tpu.sync",
    ]
    assert _names("jax", str(path)) == []


def test_cuda_requested_without_a_card_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from ffsubsync_tpu_torch.cli import make_parser
    from ffsubsync_tpu_torch.device import get_device
    from ffsubsync_tpu_torch.sync import run
    from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16

    monkeypatch.setenv("FFS_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE=cuda"):
        get_device()
    monkeypatch.delenv("FFS_TORCH_DEVICE")  # cuda is the default
    with pytest.raises(RuntimeError, match="is_available"):
        get_device()
    wav = str(tmp_path / "ref.wav")
    write_wav_i16(wav, [0.0] * 12000, 12000)
    srt = tmp_path / "in.srt"
    srt.write_text("1\n00:00:00,100 --> 00:00:00,500\nx\n\n")
    with pytest.raises(RuntimeError, match="FFS_TORCH_DEVICE"):
        run(make_parser().parse_args([wav, "-i", str(srt), "-o", str(tmp_path / "o.srt")]))


def test_unknown_device_name_raises(monkeypatch):
    from ffsubsync_tpu_torch.device import get_device

    monkeypatch.setenv("FFS_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError, match="cuda, cpu"):
        get_device()
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    assert get_device() == torch.device("cpu")
