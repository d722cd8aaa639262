# -*- coding: utf-8 -*-
"""ctypes bindings for the native host data-plane library (libffs_native).

Counterpart of ``ffsubsync_tpu/native/__init__.py``: the same entry points,
the same numpy fallbacks, the same C++ source (``csrc/ffs_native.cpp``, a
verbatim copy of ``native/ffs_native.cpp``). Two things differ, and why:

- the library is built at first use, not at import, into
  ``build/ffsubsync_tpu_torch/`` beside the package (the CUDA library's
  build directory, ``ops/_build.py``), never into a package directory. Its
  file name carries a hash of the source, the flags and the host (the build
  is ``-march=native``), and the build is serialized by one process-wide
  lock and published by an atomic rename, so the decode and segment threads
  that reach it at once share one ``g++`` run;
- the fallbacks of :func:`frame_for_device` and :func:`tokenize` take their
  pure-Python halves from this package (``ops.frontend``, ``ops.vad``).

``FFS_TPU_AUTO_BUILD_NATIVE=0`` turns the build off, as in the reference:
an existing build is still loaded, else every entry point runs in numpy.
"""
import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from typing import List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "ffs_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ffsubsync_tpu_torch")
# the reference's flags (ffsubsync_tpu/native/__init__.py)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_UNSET = object()
_lib = _UNSET  # the loaded library, None without one; tests may set None
_LOCK = threading.Lock()


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(("%s %s" % (platform.node(), platform.machine())).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, "libffs_native_%s.so" % digest.hexdigest()[:16])


def _build(path: str) -> bool:
    """Compile ``SOURCE`` to ``path``; False (logged) where no compiler is
    found or the build fails."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    # pid and thread id: other processes sharing BUILD_DIR write their own file
    tmp = "%s.tmp%d.%d" % (path, os.getpid(), threading.get_ident())
    try:
        subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, path)  # atomic: no other process loads a partial file
    except Exception as e:
        logger.debug("native library build failed: %s", e)
        return False
    logger.info("built native library at %s", path)
    return True


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ffs_pcm_s16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
    ]
    lib.ffs_pcm_s16_to_f32.restype = None
    lib.ffs_mix_to_mono_i16.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.ffs_mix_to_mono_i16.restype = None
    lib.ffs_window_energy_db.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ffs_window_energy_db.restype = ctypes.c_int64
    lib.ffs_tokenize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.ffs_tokenize.restype = ctypes.c_int64
    lib.ffs_decimate2_i16.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.ffs_decimate2_i16.restype = ctypes.c_int64
    for name, out in (("ffs_stage_i8", ctypes.c_int8), ("ffs_stage_p6", ctypes.c_uint8)):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.POINTER(out),
        ]
        fn.restype = None
    for name, elem in (("ffs_mulaw_frame_i8", ctypes.c_int8),
                       ("ffs_frame_i16", ctypes.c_int16)):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.POINTER(elem),
        ]
        fn.restype = None
    return lib


def _get_lib():
    """The library (built and loaded once per process, whichever thread
    asks first), or None where it cannot be built."""
    global _lib
    if _lib is _UNSET:
        with _LOCK:
            if _lib is _UNSET:
                path = library_path()
                if not os.path.exists(path) and os.environ.get(
                    "FFS_TPU_AUTO_BUILD_NATIVE"
                ) != "0":
                    _build(path)
                lib = None
                if os.path.exists(path):
                    try:
                        lib = _declare(ctypes.CDLL(path))
                    except (OSError, AttributeError) as e:  # pragma: no cover
                        logger.warning("failed to load native library: %s", e)
                _lib = lib
    return _lib


def __getattr__(name):
    if name == "AVAILABLE":  # as in the reference, now resolved at first use
        return _get_lib() is not None
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pcm_s16_to_f32(pcm: np.ndarray, scale: float = 1.0) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lib = _get_lib()
    if lib is None:
        return pcm.astype(np.float32) * scale
    out = np.empty(len(pcm), np.float32)
    lib.ffs_pcm_s16_to_f32(
        _ptr(pcm, ctypes.c_int16), _ptr(out, ctypes.c_float), len(pcm), scale
    )
    return out


def mix_to_mono_i16(frames: np.ndarray) -> np.ndarray:
    """[frames, channels] int16 → mono int16 (mean of channels)."""
    frames = np.ascontiguousarray(frames, dtype=np.int16)
    if frames.ndim == 1:
        return frames
    n, channels = frames.shape
    lib = _get_lib()
    if lib is None:
        # truncate toward zero, matching C++ integer division
        return (
            frames.astype(np.int32).sum(axis=1) / channels
        ).astype(np.int16)
    out = np.empty(n, np.int16)
    lib.ffs_mix_to_mono_i16(
        _ptr(frames, ctypes.c_int16), n, channels, _ptr(out, ctypes.c_int16)
    )
    return out


def window_energy_db(pcm: np.ndarray, window: int) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    n_windows = -(-len(pcm) // window)
    lib = _get_lib()
    if lib is None:
        padded = np.zeros(n_windows * window, np.float64)
        padded[: len(pcm)] = pcm.astype(np.float64)
        frames = padded.reshape(n_windows, window)
        # fallback divides by the full window; the native path divides by the
        # true tail length (matches the device kernel's padded semantics)
        power = np.maximum((frames**2).mean(axis=1), 1e-10)
        return (10.0 * np.log10(power)).astype(np.float32)
    out = np.empty(n_windows, np.float32)
    lib.ffs_window_energy_db(
        _ptr(pcm, ctypes.c_int16), len(pcm), window, _ptr(out, ctypes.c_float)
    )
    return out


# 23-tap Q15 half-band decimator taps (offset, coefficient); kept in sync
# with kHalfband* in csrc/ffs_native.cpp
_HALFBAND = ((0, 16418), (1, 10259), (3, -2931), (5, 1266), (7, -521),
             (9, 178), (11, -76))


def decimate2(pcm: np.ndarray) -> np.ndarray:
    """Half-band decimate int16 PCM by 2 (bit-exact C++/numpy parity)."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    n = len(pcm)
    n_out = (n + 1) // 2
    lib = _get_lib()
    if lib is not None:
        out = np.empty(n_out, np.int16)
        lib.ffs_decimate2_i16(_ptr(pcm, ctypes.c_int16), n,
                              _ptr(out, ctypes.c_int16))
        return out
    x = pcm.astype(np.int64)
    centers = np.arange(n_out) * 2
    acc = _HALFBAND[0][1] * x[centers]
    for off, tap in _HALFBAND[1:]:
        lo = centers - off
        hi = centers + off
        xlo = np.where(lo >= 0, x[np.maximum(lo, 0)], 0)
        xhi = np.where(hi < n, x[np.minimum(hi, n - 1)], 0)
        acc += tap * (xlo + xhi)
    return np.clip(acc >> 15, -32768, 32767).astype(np.int16)


def stage_for_device(
    pcm: np.ndarray, decim_stages: int, window: int, wpad: int, t_pad: int
) -> np.ndarray:
    """Half-band decimate ``decim_stages`` times, µ-law encode, and frame —
    all in one native pass over the raw PCM. Bit-exact vs composing
    :func:`decimate2` then :func:`frame_for_device`."""
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        pcm = pcm.astype(np.int16)
    pcm = np.ascontiguousarray(pcm)
    lib = _get_lib()
    if lib is not None:
        out = np.empty((t_pad, wpad), np.int8)
        lib.ffs_stage_i8(
            _ptr(pcm, ctypes.c_int16),
            len(pcm),
            decim_stages,
            window,
            wpad,
            t_pad,
            _ptr(out, ctypes.c_int8),
        )
        return out
    for _ in range(decim_stages):
        pcm = decimate2(pcm)
    # samples past t_pad windows are dropped, as the library drops them
    return frame_for_device(pcm[: t_pad * window], window, wpad, t_pad, mulaw=True)


def mulaw6_encode_host(pcm_i16: np.ndarray) -> np.ndarray:
    """Vectorized 6-bit µ-law encode int16 → biased uint8 codes in [0, 62].

    Same compander as :func:`ops.frontend.mulaw_encode_host`, quantized to
    31 levels per sign and biased by +31 (signed 0 → 31)."""
    x = pcm_i16.astype(np.float32) / 32768.0
    y = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log1p(255.0)
    return (np.round(y * 31.0) + 31.0).astype(np.uint8)


def pack6(codes_u8: np.ndarray) -> np.ndarray:
    """Pack biased 6-bit codes [..., 4k] → bytes [..., 3k] (4 codes → 3)."""
    u = codes_u8.astype(np.uint32).reshape(codes_u8.shape[:-1] + (-1, 4))
    b0 = (u[..., 0] << 2) | (u[..., 1] >> 4)
    b1 = ((u[..., 1] & 15) << 4) | (u[..., 2] >> 2)
    b2 = ((u[..., 2] & 3) << 6) | u[..., 3]
    out = np.stack([b0, b1, b2], axis=-1).astype(np.uint8)
    return out.reshape(codes_u8.shape[:-1] + (-1,))


def stage_for_device_p6(
    pcm: np.ndarray, decim_stages: int, window: int, t_pad: int
) -> np.ndarray:
    """6-bit µ-law wire staging: decimate + encode + pack + frame in one
    native pass → ``[t_pad, window*3//4]`` int8 (bit patterns; decoded in
    the frontend kernel's load). Padding rows/tails hold the packed silence
    pattern (biased code 31), never zero bytes."""
    if window % 4 != 0:
        raise ValueError("mulaw6 wire needs window %% 4 == 0, got %d" % window)
    row_bytes = window * 3 // 4
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        pcm = pcm.astype(np.int16)
    pcm = np.ascontiguousarray(pcm)
    lib = _get_lib()
    if lib is not None:
        out = np.empty((t_pad, row_bytes), np.uint8)
        lib.ffs_stage_p6(
            _ptr(pcm, ctypes.c_int16),
            len(pcm),
            decim_stages,
            window,
            row_bytes,
            t_pad,
            _ptr(out, ctypes.c_uint8),
        )
        return out.view(np.int8)
    for _ in range(decim_stages):
        pcm = decimate2(pcm)
    pcm = pcm[: t_pad * window]  # clamped to t_pad windows, as in the library
    codes = np.full(t_pad * window, 31, np.uint8)
    codes[: len(pcm)] = mulaw6_encode_host(pcm)
    return pack6(codes.reshape(t_pad, window)).view(np.int8)


def frame_for_device(
    pcm: np.ndarray, window: int, wpad: int, t_pad: int, mulaw: bool
) -> np.ndarray:
    """Encode (µ-law, optionally) + frame PCM into the ``[t_pad, wpad]``
    layout the frontend kernel reads, in one native pass."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lib = _get_lib()
    if lib is None:
        from ffsubsync_tpu_torch.ops.frontend import mulaw_encode_host

        dtype = np.int8 if mulaw else np.int16
        flat = np.zeros(t_pad * window, dtype)
        flat[: len(pcm)] = mulaw_encode_host(pcm) if mulaw else pcm
        framed = np.zeros((t_pad, wpad), dtype)
        framed[:, :window] = flat.reshape(t_pad, window)
        return framed
    out = np.empty((t_pad, wpad), np.int8 if mulaw else np.int16)
    (lib.ffs_mulaw_frame_i8 if mulaw else lib.ffs_frame_i16)(
        _ptr(pcm, ctypes.c_int16),
        len(pcm),
        window,
        wpad,
        t_pad,
        _ptr(out, ctypes.c_int8 if mulaw else ctypes.c_int16),
    )
    return out


def tokenize(
    valid: np.ndarray, min_length: int, max_length: int, max_silence: int
) -> List[Tuple[int, int]]:
    """Native auditok-class tokenizer; falls back to the Python state machine."""
    lib = _get_lib()
    if lib is None:
        from ffsubsync_tpu_torch.ops.vad import _tokenize_validity_py

        return _tokenize_validity_py(valid, min_length, max_length, max_silence)
    valid_u8 = np.ascontiguousarray(np.asarray(valid, dtype=bool), dtype=np.uint8)
    cap = max(1, len(valid_u8))
    starts = np.empty(cap, np.int64)
    ends = np.empty(cap, np.int64)
    count = lib.ffs_tokenize(
        _ptr(valid_u8, ctypes.c_uint8),
        len(valid_u8),
        min_length,
        max_length,
        max_silence,
        _ptr(starts, ctypes.c_int64),
        _ptr(ends, ctypes.c_int64),
        cap,
    )
    return [(int(starts[i]), int(ends[i])) for i in range(count)]
