# -*- coding: utf-8 -*-
"""ffsubsync_tpu_torch: the PyTorch/CUDA port of ffsubsync_tpu.

Same CLI, same result dict, same offsets as ``ffsubsync_tpu``; the device
work runs in PyTorch, and the fused audio frontend is a CUDA kernel written
for Hopper (``csrc/frontend.cu``). ``FFS_TORCH_DEVICE`` (``cuda`` default,
or ``cpu``) picks the device (:mod:`ffsubsync_tpu_torch.device`). The
package stands alone: it imports neither jax nor ``ffsubsync_tpu``. Its
host modules (CLI, subtitles, WAV reader, native staging, host aligner) are
copies of the JAX package's under the same module paths, and it ships its
own host library source (``csrc/ffs_native.cpp``) and neural-VAD weights.

Public API as in ``ffsubsync_tpu/__init__.py``: ``main``, ``run``,
``make_parser``, ``ProgressInfo``, ``__version__``; heavy modules load
lazily.
"""
import logging
import sys

from ffsubsync_tpu_torch.utils import tracing
from ffsubsync_tpu_torch.version import __version__  # noqa: F401

try:
    from rich.console import Console
    from rich.logging import RichHandler

    handler = RichHandler(console=Console(file=sys.stderr))
except ImportError:  # pragma: no cover
    handler = logging.StreamHandler(sys.stderr)  # type: ignore[assignment]
# each record the handler renders and writes is a ``log`` span
handler.handle = tracing.spanned("log")(handler.handle)  # type: ignore[method-assign]
logging.basicConfig(format="%(message)s", handlers=[handler], level=logging.INFO)

_LAZY = {
    "main": ("ffsubsync_tpu_torch.sync", "main"),
    "run": ("ffsubsync_tpu_torch.sync", "run"),
    "make_parser": ("ffsubsync_tpu_torch.cli", "make_parser"),
    "ProgressInfo": ("ffsubsync_tpu_torch.utils.progress", "ProgressInfo"),
}

__all__ = ["main", "run", "make_parser", "ProgressInfo", "__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module_name, attr = _LAZY[name]
        return getattr(importlib.import_module(module_name), attr)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
