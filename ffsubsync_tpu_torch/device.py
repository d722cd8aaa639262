# -*- coding: utf-8 -*-
"""The one place the port chooses its device.

``FFS_TORCH_DEVICE`` plays the role ``JAX_PLATFORMS`` plays for the JAX
package: ``cuda`` (the default) or ``cpu``. Asking for ``cuda`` on a machine
without a usable GPU raises — the port never carries on on the CPU behind
the user's back. Callers resolve the device once and pass it down.

A *mesh* is a sequence of ``torch.device``s that one process drives
(:func:`local_mesh`, the counterpart of ``jax.devices()``): the sharded
VAD (``parallel/vad_shard.py``) and the batch search
(``parallel/batch.py``) spread their work over it.
"""
import os
from typing import Tuple

import torch

DEVICE_ENV = "FFS_TORCH_DEVICE"
_CHOICES = ("cuda", "cpu")


def get_device() -> torch.device:
    name = os.environ.get(DEVICE_ENV, "cuda")
    if name not in _CHOICES:
        raise ValueError(
            "%s=%r: choose one of %s" % (DEVICE_ENV, name, ", ".join(_CHOICES))
        )
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "%s=cuda but torch.cuda.is_available() is False (torch %s); set "
            "%s=cpu to run the port's plain PyTorch path on the CPU"
            % (DEVICE_ENV, torch.__version__, DEVICE_ENV)
        )
    return torch.device(name)


def local_mesh(device: torch.device) -> Tuple[torch.device, ...]:
    """The distinct local devices of ``device``'s kind: every ``cuda:i``
    for a CUDA device, ``(cpu,)`` for the CPU."""
    if device.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)
