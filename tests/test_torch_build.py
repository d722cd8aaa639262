# -*- coding: utf-8 -*-
"""The kernel build under concurrent first use: the multi-segment and batch
paths reach ``_build.build_library`` from several threads at once, and one
compiler run must serve them all (a fake ``nvcc`` stands in for the real
one, which this machine does not have)."""
import os
import stat
import threading

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
