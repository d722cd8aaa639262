# -*- coding: utf-8 -*-
"""Build and load the port's CUDA kernels (``ffsubsync_tpu_torch/csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one compiler
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The build
happens at first use, into ``build/ffsubsync_tpu_torch/`` beside the
package, and the library's file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.
Nothing here runs at import time: the CPU test suite imports every module
on a machine with no ``nvcc``. Building and loading are serialized by one
process-wide lock: the multi-segment and batch paths reach the first kernel
launch from several threads at once, and one build must serve them all.
"""
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ffsubsync_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# re-entrant: load_library builds while holding it
_LOCK = threading.RLock()


class BuildResult(NamedTuple):
    path: str  # the shared library
    seconds: float  # nvcc wall time; 0.0 when a cached build was reused
    log: str  # the compilers' stderr (ptxas register/shared-memory report)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then the
    toolkit's default install location."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and %s): the CUDA "
        "kernels of ffsubsync_tpu_torch cannot be built" % default
    )


def _sources():
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise RuntimeError("no CUDA sources under %s" % CSRC_DIR)
    return sources


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, "libffs_torch_%s.so" % digest.hexdigest()[:16])


def _run_all(cmds):
    """Runs the commands at once; raises with the stderr of any that
    failed. Returns their stderr, joined in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [p.communicate()[1] for p in procs]
    failed = [(p.returncode, err) for p, err in zip(procs, errs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed (exit %d):\n%s"
                           % (failed[0][0], "\n".join(err for _rc, err in failed)))
    return "".join(errs)


def build_library() -> BuildResult:
    """Compile the kernels unless a build of the same sources exists: one
    nvcc per source, all at once, then one link. Raises with nvcc's stderr
    when the build fails. Thread-safe: concurrent callers wait for one
    build and share its library."""
    with _LOCK:
        path = library_path()
        if os.path.exists(path):
            return BuildResult(path, 0.0, "")
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # a directory of this process's own: other processes sharing
        # BUILD_DIR build theirs
        work = tempfile.mkdtemp(prefix=".objs-", dir=BUILD_DIR)
        try:
            t0 = time.perf_counter()
            objs = [os.path.join(work, "%d.o" % i) for i in range(len(_sources()))]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                            for obj, src in zip(objs, _sources())])
            tmp = os.path.join(work, "lib.so")
            log += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
            seconds = time.perf_counter() - t0
            os.replace(tmp, path)  # atomic: no other process loads a partial file
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return BuildResult(path, seconds, log)


def load_library() -> ctypes.CDLL:
    """The kernels' library with every entry point's signature declared
    (built and loaded once per process, whichever thread asks first)."""
    with _LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library().path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ffs_frontend_launch.argtypes = [
        ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
    ]
    lib.ffs_frontend_launch.restype = i32
    lib.ffs_frontend_config.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.ffs_frontend_config.restype = i32
    i64 = ctypes.c_longlong
    lib.ffs_scan_launch.argtypes = [i32, i32, i32, i64, i32] + [ptr] * 5 + [i32, i32, ptr]
    lib.ffs_scan_launch.restype = i32
    lib.ffs_scan_launch_two_level.argtypes = [i32, i32, i32, i64, i32] + [ptr] * 7
    lib.ffs_scan_launch_two_level.restype = i32
    lib.ffs_scan_workspace_words.argtypes = [i32]
    lib.ffs_scan_workspace_words.restype = i64
    lib.ffs_scan_tile_rows.argtypes = []
    lib.ffs_scan_tile_rows.restype = i32
    lib.ffs_cuda_error_string.argtypes = [i32]
    lib.ffs_cuda_error_string.restype = ctypes.c_char_p
    return lib
