# -*- coding: utf-8 -*-
import os

from setuptools import find_packages, setup

from ffsubsync_tpu.constants import DESCRIPTION, LONG_DESCRIPTION, PROJECT_NAME
from ffsubsync_tpu.version import __version__

# pin the git-derived version into the build so installed artifacts (which
# carry no git metadata) report the exact version they were built from
_version_py = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "ffsubsync_tpu", "_version.py"
)
with open(_version_py, "w") as f:
    f.write(
        "# generated by setup.py; do not edit\nversion = %r\n" % __version__
    )

setup(
    name=PROJECT_NAME,
    version=__version__,
    description=DESCRIPTION,
    long_description=LONG_DESCRIPTION,
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={
        # trained neural-VAD weights ship with the package (one file per
        # analysis rate); without these --vad silero/fused degrades to a
        # random-init net with only a log warning
        "ffsubsync_tpu": ["models/weights/*.npz"],
        # the PyTorch port's CUDA kernels and host library are built from
        # source at first use; it ships its own copy of the weights
        "ffsubsync_tpu_torch": ["csrc/*.cu", "csrc/*.cpp", "models/weights/*.npz"],
    },
    # 3.10 floor: jax releases with the top-level jax.shard_map API used by
    # ffsubsync_tpu/parallel require >=3.10 (jax dropped 3.9 earlier)
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "charset-normalizer",
    ],
    extras_require={
        "neural": ["flax", "optax"],
        "rich": ["rich"],
        "progress": ["tqdm"],
        # the PyTorch/CUDA port (ffsubsync_tpu_torch); CUDA builds of torch
        # come from PyTorch's own package index
        "cuda": ["torch"],
    },
    entry_points={
        "console_scripts": [
            "ffs=ffsubsync_tpu.sync:main",
            "subsync=ffsubsync_tpu.sync:main",
            "ffsubsync=ffsubsync_tpu.sync:main",
            "ffs-tpu=ffsubsync_tpu.sync:main",  # Docker/docs entry name
            "ffs-tpu-batch=ffsubsync_tpu.batch:main",
            "ffs-torch=ffsubsync_tpu_torch.sync:main",  # PyTorch/CUDA port
            "ffs-torch-batch=ffsubsync_tpu_torch.batch:main",
        ],
    },
    zip_safe=False,
)
