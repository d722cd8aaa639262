# -*- coding: utf-8 -*-
"""The port's own copies of the JAX package's host code stay equal to their
originals: module sources (the package name substituted, the port's spans
taken out), the functions merged into port modules, the host library's C++
source, the weight files, what the two host libraries compute,
``__version__`` and the CLI parser (the ``--profile-dir`` help apart)."""
import ctypes
import hashlib
import importlib
import inspect
import os
import re
import shutil
import subprocess
import time

import numpy as np
import pytest

import ffsubsync_tpu
import ffsubsync_tpu_torch
from ffsubsync_tpu import native as jnative
from ffsubsync_tpu.cli import make_parser as jax_make_parser
from ffsubsync_tpu_torch import native as tnative
from ffsubsync_tpu_torch.cli import make_parser as torch_make_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "ffsubsync_tpu")
PKG_DIR = os.path.join(REPO, "ffsubsync_tpu_torch")

# modules copied whole, under the same path in both packages
VERBATIM = [
    "constants.py", "version.py", "validation.py", "cli.py", "speech.py",
    "utils/__init__.py", "utils/encodings.py", "utils/file_io.py",
    "utils/progress.py", "utils/archive.py", "utils/fixtures.py",
    "subs/__init__.py", "subs/model.py", "subs/metadata.py", "subs/srt_format.py",
    "subs/ssa_format.py", "subs/formats.py", "subs/parser.py", "subs/transforms.py",
    "subs/raster.py",
    "media/ffmpeg.py", "media/wav.py", "media/embedded.py", "media/pgs.py",
    "models/synth_data.py", "models/eval_data.py", "gui.py",
]
# functions and classes copied into a port module that does more
MERGED = [
    ("ops.align", name) for name in (
        "FailedToFindAlignmentException", "next_pow2", "Alignment", "_offset_window",
        "_resolve_host_align", "_host_pm", "_align_candidates_host", "_ref_length",
    )
] + [
    ("sync", name) for name in (
        "get_srt_source_maker", "get_framerate_ratios_to_try", "assess_alignment_quality",
        "gss_grid", "gss_narrow", "extract_subtitles_from_reference", "_setup_logging",
        "_npy_savename", "validate_and_transform_args", "override",
    )
] + [
    ("models.synth_data", name)
    for name in ("speech_signal_for_spans", "_moving_formant_speech")
]
MERGED_VALUES = [
    ("ops.align", "RefLike"), ("sync", "MIN_FRAMERATE_RATIO"), ("sync", "MAX_FRAMERATE_RATIO"),
    ("sync", "GSS_TOL"), ("sync", "_GSS_GRID_K"),
]
WEIGHTS = sorted(os.listdir(os.path.join(JAX_DIR, "models", "weights")))
CLI_LINES = [
    ["ref.mkv", "-i", "in.srt", "-o", "out.srt"],
    ["ref.wav", "-i", "in.srt", "--vad", "fused", "--gss", "--max-offset-seconds", "30"],
    ["ref.wav", "-i", "a.srt", "b.srt", "--multi-segment-sync", "--segment-count", "4"],
    ["ref.srt", "-i", "in.ass", "--no-fix-framerate", "--encoding", "cp1252",
     "--output-encoding", "same", "--merge-with-reference"],
    ["ref.mkv", "--extract-subs-from-stream", "s:1", "-o", "x.srt"],
    ["ref.wav", "-i", "in.srt", "--vad", "auditok", "--frame-rate", "16000",
     "--skip-sync-on-low-quality", "--min-score", "1.5"],
]


def _port_text(text: str) -> str:
    return re.sub(r"\bffsubsync_tpu\b", "ffsubsync_tpu_torch", text)


# What the port adds to its copies: the import of its tracing module, span
# decorators, and span blocks (a ``with`` line, its block one level deeper).
# The JAX package traces nothing of its own; the --profile-dir help names the
# profiler each package writes with.
TRACING_IMPORT = "from ffsubsync_tpu_torch.utils import tracing\n"
SPAN_DECORATOR = re.compile(r'^\s*@tracing\.spanned\("[a-z_]+"\)\n$')
SPAN_BLOCK = re.compile(r'^\s*with tracing\.span\("[a-z_]+"\):\n$')
PROFILE_DIR_HELP = (
    """        help="Capture a device profile of the sync into this directory "
        "(jax.profiler trace, viewable in TensorBoard/XProf or Perfetto). "
        "The reference has no profiler; this is TPU-native observability.",
""",
    """        help="Write a torch.profiler Chrome trace of the sync into this "
        "directory (trace.json, viewable in Perfetto or chrome://tracing): "
        "the device's kernels and the program's spans (parse, raster, read, "
        "stage, vad_program, align, write, ...). The reference has no profiler.",
""",
)


def _without_spans(text: str) -> str:
    """The port's source with its spans taken out: what it was copied as."""
    text = text.replace("\n\n" + TRACING_IMPORT + "\n", "\n\n").replace(TRACING_IMPORT, "")
    out, blocks = [], []  # the indents of the span blocks open
    for line in text.splitlines(True):
        if line.strip():
            indent = len(line) - len(line.lstrip(" "))
            while blocks and indent <= blocks[-1]:
                blocks.pop()
            if SPAN_DECORATOR.match(line):
                continue
            if SPAN_BLOCK.match(line):
                blocks.append(indent)
                continue
            cut = 4 * len(blocks)
            assert line[:cut].strip() == "", line
            line = line[cut:]
        out.append(line)
    return "".join(out)


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("module", VERBATIM)
def test_module_is_a_verbatim_copy(module):
    want = _port_text(_read(os.path.join(JAX_DIR, module)))
    if module == "cli.py":
        assert want.count(PROFILE_DIR_HELP[0]) == 1
        want = want.replace(*PROFILE_DIR_HELP)
    assert _without_spans(_read(os.path.join(PKG_DIR, module))) == want


@pytest.mark.parametrize("module,name", MERGED, ids=["%s.%s" % m for m in MERGED])
def test_merged_source_is_a_verbatim_copy(module, name):
    ours = getattr(importlib.import_module("ffsubsync_tpu_torch." + module), name)
    theirs = getattr(importlib.import_module("ffsubsync_tpu." + module), name)
    assert _without_spans(inspect.getsource(ours)) == _port_text(inspect.getsource(theirs))


@pytest.mark.parametrize("module,name", MERGED_VALUES, ids=["%s.%s" % m for m in MERGED_VALUES])
def test_merged_value_equals_original(module, name):
    ours = getattr(importlib.import_module("ffsubsync_tpu_torch." + module), name)
    theirs = getattr(importlib.import_module("ffsubsync_tpu." + module), name)
    assert repr(ours) == _port_text(repr(theirs))


def test_native_source_is_a_byte_copy():
    with open(os.path.join(REPO, "native", "ffs_native.cpp"), "rb") as f:
        want = f.read()
    with open(tnative.SOURCE, "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", WEIGHTS)
def test_weight_file_is_byte_equal(name):
    digests = []
    for pkg in (JAX_DIR, PKG_DIR):
        with open(os.path.join(pkg, "models", "weights", name), "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]


def test_native_builds_into_the_port_build_dir():
    assert tnative.AVAILABLE, "g++ could not build csrc/ffs_native.cpp"
    assert os.path.dirname(tnative.library_path()) == os.path.join(
        REPO, "build", "ffsubsync_tpu_torch"
    )
    assert os.path.exists(tnative.library_path())


def _pcm(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 6000).clip(-32768, 32767).astype(np.int16)


NATIVE_CALLS = {
    # (function name, arguments); each runs on both libraries
    "stage_for_device": ("stage_for_device", (_pcm(48000 + 333, 1), 2, 120, 128, 110)),
    "stage_for_device_p6": ("stage_for_device_p6", (_pcm(24000 + 77, 2), 1, 120, 105)),
    # more decimated samples than t_pad windows hold: the library clamps
    "stage_for_device_clamped": ("stage_for_device", (_pcm(24000, 8), 1, 120, 128, 50)),
    "stage_for_device_p6_clamped": ("stage_for_device_p6", (_pcm(24000, 9), 1, 120, 50)),
    "frame_for_device_mulaw": ("frame_for_device", (_pcm(9000 + 5, 3), 160, 160, 60, True)),
    "frame_for_device_i16": ("frame_for_device", (_pcm(9000 + 5, 4), 80, 128, 120, False)),
    "window_energy_db": ("window_energy_db", (_pcm(12000 + 61, 5), 120)),
    "tokenize": ("tokenize", (np.random.RandomState(6).rand(5000) > 0.4, 5, 60, 3)),
    "decimate2": ("decimate2", (_pcm(10001, 7),)),
}


# how long to wait for another process's build of the reference's library
# (one g++ -O3 run of native/ffs_native.cpp: seconds)
REFERENCE_BUILD_WAIT_S = 90.0


def _loadable(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:  # missing, or still being linked by another process
        return False
    return True


def _build_reference_library() -> None:
    """Build ``native/ffs_native.cpp`` with the reference's own compiler
    line (``ffsubsync_tpu/native/__init__.py``) into a file of this process
    and rename it onto the reference's library path, so that no process
    ever loads a partly written file."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.fail("no g++ or clang++ on PATH: the reference's native library cannot be built")
    tmp = "%s.tmp%d" % (jnative._LIB_PATH, os.getpid())
    try:
        subprocess.run(
            [cxx, "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
             "-o", tmp, os.path.join(REPO, "native", "ffs_native.cpp")],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, jnative._LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def repair_reference_library(wait_s: float = REFERENCE_BUILD_WAIT_S) -> None:
    """Load the reference's host library in this process if it is not.

    The reference builds its library at import straight onto its final
    path, so of several processes importing it at once (pytest-xdist's
    workers, at collection), one that finds the file half linked runs
    without it for its whole life. Wait up to ``wait_s`` for the file to
    load, else build it here; then reload the module. Reloading runs its
    code again in the same module namespace, so functions imported from it
    earlier see the new library too."""
    if jnative._lib is not None and jnative.AVAILABLE:
        return
    deadline = time.monotonic() + wait_s
    while not _loadable(jnative._LIB_PATH) and time.monotonic() < deadline:
        time.sleep(0.5)
    importlib.reload(jnative)
    if jnative._lib is None:
        _build_reference_library()
        importlib.reload(jnative)
    if jnative._lib is None:
        pytest.fail("the reference's native library at %s does not load" % jnative._LIB_PATH)


@pytest.fixture(scope="module")
def reference_library():
    repair_reference_library()


@pytest.mark.parametrize("call", sorted(NATIVE_CALLS))
def test_native_libraries_agree(call, reference_library):
    """The port's library, the reference's and the port's numpy fallback
    give identical results on seeded random PCM."""
    name, args = NATIVE_CALLS[call]
    ours = getattr(tnative, name)(*args)
    theirs = getattr(jnative, name)(*args)
    assert jnative.AVAILABLE and tnative.AVAILABLE
    if name == "tokenize":
        assert ours == theirs and ours
    else:
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("rebuild", [False, True], ids=["reload", "rebuild"])
def test_reference_library_repair(rebuild, reference_library):
    """A process whose reference module lost its library (as one that lost
    the import race does) gets it back from the repair: loaded from the
    file, or from a fresh build renamed onto it, with the same outputs."""
    pcm = _pcm(24000 + 77, 2)
    want = tnative.stage_for_device_p6(pcm, 1, 120, 105)
    if rebuild:
        _build_reference_library()
        assert _loadable(jnative._LIB_PATH)
    jnative._lib = None  # not monkeypatched: its teardown would undo the repair
    repair_reference_library(wait_s=0.0)
    assert jnative.AVAILABLE and jnative._lib is not None
    np.testing.assert_array_equal(jnative.stage_for_device_p6(pcm, 1, 120, 105), want)


@pytest.mark.parametrize("call", sorted(set(NATIVE_CALLS) - {"window_energy_db"}))
def test_native_fallback_agrees(call, monkeypatch):
    """The numpy fallbacks (no library) give the library's results; the
    energy fallback divides a short tail by the full window, as in the
    reference, and is left out."""
    name, args = NATIVE_CALLS[call]
    want = getattr(tnative, name)(*args)
    monkeypatch.setattr(tnative, "_lib", None)
    assert not tnative.AVAILABLE
    got = getattr(tnative, name)(*args)
    if name == "tokenize":
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


def test_version_equals_reference():
    assert ffsubsync_tpu_torch.__version__ == ffsubsync_tpu.__version__


@pytest.mark.parametrize("argv", CLI_LINES, ids=[" ".join(a[2:5]) for a in CLI_LINES])
def test_parser_gives_equal_namespaces(argv):
    assert vars(torch_make_parser().parse_args(argv)) == vars(jax_make_parser().parse_args(argv))


def test_parser_has_every_flag_and_help():
    def flags(parser):
        return [(a.option_strings, a.dest, a.default,
                 "<profiler>" if a.dest == "profile_dir" else a.help, a.choices, a.nargs)
                for a in parser._actions]

    assert flags(torch_make_parser()) == flags(jax_make_parser())
    help_of = {a.dest: a.help for a in torch_make_parser()._actions}
    assert "torch.profiler" in help_of["profile_dir"] and "jax" not in help_of["profile_dir"]
