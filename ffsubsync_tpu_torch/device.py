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
from typing import List, Sequence, Tuple

import numpy as np
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


def mesh_groups(n: int, mesh: Sequence[torch.device]) -> List[Tuple[int, torch.device, slice]]:
    """(slot, device, contiguous index range) of each slot of ``mesh`` that
    gets some of ``n`` items, split as ``np.array_split`` splits them: the
    first ``n % len(mesh)`` groups one item longer."""
    return [(i, dev, slice(g[0], g[-1] + 1))
            for i, (dev, g) in enumerate(zip(mesh, np.array_split(np.arange(n), len(mesh))))
            if len(g)]


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device``, copied without waiting for the
    device. A plain ``.to(cuda)`` of pageable memory waits for all work
    queued on the stream (PyTorch synchronizes after its copy), which
    stalls a pipeline whose next chunk is staged while the card runs this
    one; from page-locked memory the copy is queued like a kernel, and the
    caching host allocator keeps the pinned block until it has run. A CPU
    device takes the array as it is."""
    tensor = torch.from_numpy(array)
    if device.type != "cuda":
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)
