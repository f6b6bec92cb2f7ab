"""Device mesh construction.

The reference has no distributed execution at all — its only parallelism
is MKL's in-process OpenMP threading (``README.md:9-10``,
``_cfunctions.py:742-747``).  This package is the scaling layer this
build adds: matrices are row/block-partitioned over a
``jax.sharding.Mesh`` and ops run under ``shard_map`` with XLA
collectives between the devices.
"""

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(shape=None, axis_names=("rows", "cols"), devices=None):
    """Build a mesh over the available devices.

    shape=None gives a 1-D mesh over all devices on the first axis.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"Mesh shape {shape} does not match device count {n}"
        )
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names[: dev_array.ndim])


def device_mesh_info():
    return {
        "devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
        "platform": jax.default_backend(),
    }
