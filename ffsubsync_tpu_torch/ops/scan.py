# -*- coding: utf-8 -*-
"""Inclusive scans along dim 0: the CUDA kernel, its plain PyTorch version.

Every recurrence of the webrtc-class detector (``ops/vad.
_webrtc_from_bands`` and its sharded copy, ``parallel/vad_shard.
_sharded_webrtc``) is one of these scans: the EMA is an affine scan
(:func:`affine_scan`), the noise floor a running minimum, the flux and
modulation boxes prefix sums, the hangover a running max and a reverse
running min (:func:`scan_cols`). In the reference each is a call of
``ffsubsync_tpu/ops/vad.py::_blocked_scan``, the two-level associative
scan of 4096-row blocks.

A CUDA tensor launches the hand-written kernel of ``csrc/scan.cu``: one
launch per wrapper call (counted in :data:`launches`), one block per
4096-row tile (the reference's blocks), each block combining its tile's
local scan with the totals of the tiles before it, read in a fixed order so
that every run gives the same bits. A CPU tensor runs the plain version
(:func:`scan_cols_plain`, :func:`affine_scan_plain`: ``torch.cumsum``,
``cummin``, ``cummax`` and a doubling scan). There is no fallback between
the two: a CUDA tensor gets the kernel or an exception.
:func:`two_level_scan` runs the kernel's former three-launch design, a
yardstick that the port never calls.
"""
import threading
from typing import Tuple

import torch

TILE_ROWS = 4096  # csrc/scan.cu's kTile, the reference's _SCAN_BLOCK
WIDTHS = (1, 2, 6)  # the C of an [N, C] that csrc/scan.cu scans (the detector's)

# csrc/scan.cu's enum OpCode, by (op, dtype)
_OPS = {
    ("add", torch.float32): 0,
    ("min", torch.float32): 1,
    ("max", torch.float32): 2,
    ("min", torch.int32): 3,
    ("max", torch.int32): 4,
}
_AFFINE = 5

# calls of scan_cols and affine_scan that launched the kernel; the
# multi-segment and batch paths launch from threads
launches = 0
_LAUNCHES_LOCK = threading.Lock()


def scan_cols_plain(x: torch.Tensor, op: str, reverse: bool = False) -> torch.Tensor:
    """The plain version of :func:`scan_cols`: ``torch.cumsum``,
    ``cummin`` or ``cummax`` along dim 0, between two flips for
    ``reverse``."""
    if op not in ("add", "min", "max"):
        raise ValueError("scan_cols: unknown op %r" % (op,))
    if reverse:
        return torch.flip(scan_cols_plain(torch.flip(x, [0]), op), [0])
    if op == "add":
        return torch.cumsum(x, dim=0)
    if op == "min":
        return torch.cummin(x, dim=0).values
    return torch.cummax(x, dim=0).values


def affine_scan_plain(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`affine_scan`: a Hillis–Steele doubling
    scan, log2(T) elementwise passes."""
    t = a.shape[0]
    shift = 1
    while shift < t:
        a, b = (
            torch.cat([a[:shift], a[shift:] * a[:-shift]]),
            torch.cat([b[:shift], a[shift:] * b[:-shift] + b[shift:]]),
        )
        shift *= 2
    return a, b


def _check(lib, status: int) -> None:
    if status != 0:
        raise RuntimeError("scan kernel launch failed: %s (cudaError %d)"
                           % (lib.ffs_cuda_error_string(status).decode(), status))


class _Workspace:
    """One stream's scratch of the kernel (the tile counter, the published
    tile totals, each stamped with its launch's epoch), zeroed once;
    ``epoch`` numbers its launches."""

    __slots__ = ("buf", "cap_tiles", "epoch")

    def __init__(self, lib, device, cap_tiles):
        self.buf = torch.zeros(lib.ffs_scan_workspace_words(cap_tiles), dtype=torch.int32,
                               device=device)
        self.cap_tiles, self.epoch = cap_tiles, 0


# (device index, stream) -> _Workspace; grown when a longer scan arrives,
# made anew before its epoch would overflow int32
_WORKSPACES = {}


def _next_launch(lib, device, stream: int, n_tiles: int):
    """The workspace of ``stream`` for ``n_tiles`` tiles and a fresh epoch,
    under :data:`_LAUNCHES_LOCK`: every launch on a workspace has its own
    epoch, whichever thread asks first. The caller holds the workspace
    until its launch is queued: a workspace replaced by a larger one is
    freed to the stream's cache only then."""
    with _LAUNCHES_LOCK:
        ws = _WORKSPACES.get((device.index, stream))
        if ws is None or ws.cap_tiles < n_tiles or ws.epoch >= 2 ** 31 - 1:
            cap = max(n_tiles, 2 * ws.cap_tiles if ws is not None else 256)
            ws = _WORKSPACES[(device.index, stream)] = _Workspace(lib, device, cap)
        ws.epoch += 1
        return ws, ws.epoch


def _shape(x):
    return x.shape[0], 1 if x.dim() == 1 else x.shape[1]


def _ptrs(ts):
    return ([t.data_ptr() for t in ts] + [None, None])[:2]


def _launch(code: int, reverse: bool, xs, ys) -> None:
    """One kernel launch: ``xs`` and ``ys`` are one or two contiguous
    ``[N, C]`` (or ``[N]``) tensors on one CUDA device."""
    from ffsubsync_tpu_torch.ops import _build

    lib = _build.load_library()
    n, c = _shape(xs[0])
    dev = xs[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws, epoch = _next_launch(lib, dev, stream, -(-n // TILE_ROWS))
    _check(lib, lib.ffs_scan_launch(dev.index, code, int(reverse), n, c, *_ptrs(xs), *_ptrs(ys),
                                    ws.buf.data_ptr(), ws.cap_tiles, epoch, stream))
    global launches
    with _LAUNCHES_LOCK:
        launches += 1


def _cuda_input(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, x.device))
    if x.dim() not in (1, 2):
        raise ValueError("%s: want [N] or [N, C], got shape %r" % (what, tuple(x.shape)))
    if x.dim() == 2 and x.shape[1] not in WIDTHS:
        raise ValueError("%s: the kernel scans %s columns, got %d"
                         % (what, " or ".join(map(str, WIDTHS)), x.shape[1]))
    return x.contiguous()


def scan_cols(x: torch.Tensor, op: str, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``x`` (``[N]`` or ``[N, C]``) along dim 0 with
    ``op``: "add" (float32), "min" or "max" (float32 or int32); with
    ``reverse`` each row takes the rows from it to the end. A CUDA tensor
    launches the kernel, a CPU tensor runs :func:`scan_cols_plain`."""
    if x.device.type == "cpu":
        return scan_cols_plain(x, op, reverse)
    x = _cuda_input(x, "scan_cols")
    code = _OPS.get((op, x.dtype))
    if code is None:
        raise ValueError("scan_cols: no kernel for op %r on %s" % (op, x.dtype))
    if reverse and op == "add":
        raise ValueError("scan_cols: the kernel scans min and max in reverse, not add")
    y = torch.empty_like(x)
    if x.shape[0]:
        _launch(code, reverse, [x], [y])
    return y


def affine_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 0 of the affine maps ``y -> a*y + b``:
    composing the earlier map (a1, b1) with the later (a2, b2) gives
    (a1·a2, a2·b1 + b2); identity rows (a=1, b=0) pass a prefix through
    unchanged. A CUDA pair of float32 tensors of one shape launches the
    kernel, a CPU pair runs :func:`affine_scan_plain`."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return affine_scan_plain(a, b)
    a, b = _cuda_input(a, "affine_scan"), _cuda_input(b, "affine_scan")
    if a.shape != b.shape or a.device != b.device or {a.dtype, b.dtype} != {torch.float32}:
        raise ValueError("affine_scan: want two float32 tensors of one shape on one device, "
                         "got %s %r on %s and %s %r on %s"
                         % (a.dtype, tuple(a.shape), a.device, b.dtype, tuple(b.shape), b.device))
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    if a.shape[0]:
        _launch(_AFFINE, False, [a, b], [out_a, out_b])
    return out_a, out_b


def two_level_scan(xs, op: str, reverse: bool = False):
    """The kernel's former design on CUDA tensors, kept as a yardstick
    (``chip_smoke.py`` and the ``cuda`` tests hold the one-pass kernel
    against it bit for bit and time the two; the port never calls it, and
    it counts no launch): three launches per scan (the tile totals, their
    scan on one block, every tile scanned again with its prefix) and
    scratch for the totals per call. ``xs`` is ``(x,)`` for ``op`` "add",
    "min" or "max", or the pair ``(a, b)`` for "affine"; returns a tuple of
    outputs."""
    from ffsubsync_tpu_torch.ops import _build

    lib = _build.load_library()
    code = _AFFINE if op == "affine" else _OPS[(op, xs[0].dtype)]
    xs = [_cuda_input(x, "two_level_scan") for x in xs]
    ys = [torch.empty_like(x) for x in xs]
    n, c = _shape(xs[0])
    if n:
        dev = xs[0].device
        n_tiles = -(-n // TILE_ROWS)
        totals = ([torch.empty((n_tiles, c), dtype=x.dtype, device=dev) for x in xs]
                  if n_tiles > 1 else [])
        _check(lib, lib.ffs_scan_launch_two_level(
            dev.index, code, int(reverse), n, c, *_ptrs(xs), *_ptrs(ys), *_ptrs(totals),
            torch.cuda.current_stream(dev).cuda_stream))
    return tuple(ys)
