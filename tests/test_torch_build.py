# -*- coding: utf-8 -*-
"""The kernel build under concurrent first use: the multi-segment and batch
paths reach ``_build.build_library`` from several threads at once, and one
compiler run must serve them all (a fake ``nvcc`` stands in for the real
one, which this machine does not have). The host library's build, with the
real ``g++``, likewise."""
import os
import stat
import threading

import numpy as np
import torch

from ffsubsync_tpu_torch.ops import _build

torch.set_num_threads(1)

_FAKE_NVCC = """#!/bin/sh
# sleeps (so concurrent callers overlap), logs the run, writes its -o file
sleep 0.3
echo run >> "%s"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
"""


def _fake_nvcc(tmp_path):
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(_FAKE_NVCC % log)
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return str(script), log


def test_concurrent_first_build_runs_the_compiler_once(tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    barrier = threading.Barrier(8)
    results, errors = [], []

    def first_use():
        barrier.wait(timeout=30)
        try:
            results.append(_build.build_library())
        except Exception as e:  # reported by the assertions below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(log.read_text().splitlines()) == 1
    paths = {r.path for r in results}
    assert paths == {_build.library_path()}
    assert sum(r.seconds > 0 for r in results) == 1  # the rest reused it
    assert os.listdir(str(build_dir)) == [os.path.basename(paths.pop())]


def test_existing_build_is_reused(tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    first = _build.build_library()
    again = _build.build_library()
    assert first.path == again.path and again.seconds == 0.0
    assert len(log.read_text().splitlines()) == 1


def test_host_library_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """The port's host library (csrc/ffs_native.cpp, g++) is built at first
    use, once, into its build directory, whichever threads ask at once."""
    from ffsubsync_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", native._UNSET)
    real_build, runs = native._build, []

    def counted(path):
        runs.append(path)
        return real_build(path)

    monkeypatch.setattr(native, "_build", counted)
    barrier = threading.Barrier(8)
    libs = []

    def first_use():
        barrier.wait(timeout=30)
        libs.append(native._get_lib())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(runs) == 1 and len(libs) == 8
    assert libs[0] is not None and all(lib is libs[0] for lib in libs)
    assert os.listdir(str(tmp_path / "build")) == [os.path.basename(native.library_path())]
    assert not [f for f in os.listdir(os.path.dirname(native.__file__)) if f.endswith(".so")]
    pcm = (np.arange(-5000, 5000) * 7).astype(np.int16)
    built = native.decimate2(pcm)
    monkeypatch.setattr(native, "_lib", None)  # the numpy fallback agrees
    np.testing.assert_array_equal(built, native.decimate2(pcm))
