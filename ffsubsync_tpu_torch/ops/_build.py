# -*- coding: utf-8 -*-
"""Build and load the port's CUDA kernels (``ffsubsync_tpu_torch/csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with :mod:`ctypes`. The
build happens at first use, into ``build/ffsubsync_tpu_torch/`` beside the
package, and the library's file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.
Nothing here runs at import time: the CPU test suite imports every module
on a machine with no ``nvcc``. Building and loading are serialized by one
process-wide lock: the multi-segment and batch paths reach the first kernel
launch from several threads at once, and one nvcc run must serve them all.
"""
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ffsubsync_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# re-entrant: load_library builds while holding it
_LOCK = threading.RLock()


class BuildResult(NamedTuple):
    path: str  # the shared library
    seconds: float  # nvcc wall time; 0.0 when a cached build was reused
    log: str  # nvcc's stderr (ptxas register/shared-memory report)


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, "libffs_torch_%s.so" % digest.hexdigest()[:16])


def build_library() -> BuildResult:
    """Compile the kernels unless a build of the same sources exists.
    Raises with nvcc's stderr when the build fails. Thread-safe: concurrent
    callers wait for one build and share its library."""
    with _LOCK:
        path = library_path()
        if os.path.exists(path):
            return BuildResult(path, 0.0, "")
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # pid and thread id: other processes sharing BUILD_DIR write their own file
        tmp = "%s.tmp%d.%d" % (path, os.getpid(), threading.get_ident())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()],
            capture_output=True,
            text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed (exit %d):\n%s" % (proc.returncode, proc.stderr)
            )
        os.replace(tmp, path)  # atomic: no other process loads a partial file
        return BuildResult(path, seconds, proc.stderr)


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
    lib.ffs_cuda_error_string.argtypes = [i32]
    lib.ffs_cuda_error_string.restype = ctypes.c_char_p
    return lib
