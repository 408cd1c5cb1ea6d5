"""Device mesh construction for (batch, y, x) decompositions."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def mesh_shape_for(n_devices: int, batch: int = 1) -> tuple:
    """Factor ``n_devices`` into a (batch, y, x) mesh shape.  The spatial part
    is kept as square as possible so the halo perimeter (inter-device traffic)
    is minimal."""
    assert n_devices % batch == 0, (n_devices, batch)
    spatial = n_devices // batch
    y = int(np.sqrt(spatial))
    while spatial % y != 0:
        y -= 1
    return (batch, y, spatial // y)


def make_mesh(n_devices: int | None = None, batch: int = 1,
              devices=None) -> Mesh:
    """Create a ('batch', 'y', 'x') mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    shape = mesh_shape_for(n_devices, batch)
    arr = np.array(devices[:n_devices]).reshape(shape)
    return Mesh(arr, ("batch", "y", "x"))
