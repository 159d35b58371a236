"""Device mesh construction.

Axes:
  "slots" — dataset slots distributed across device groups (outer: slots
            are independent until the tiny dataset tree at the top)
  "cells" — cells/leaves of one slot distributed across the devices of a
            group (inner: the per-layer frontier gathers)

The cards of one host are joined all to all (NVLink), so a mesh's shape
follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

cells_axis = "cells"
slots_axis = "slots"


def make_mesh(n_cells_shards: int | None = None, n_slot_shards: int = 1, devices=None) -> Mesh:
    """(slots, cells) mesh over the available devices.

    Default: all devices on the cells axis.  n_slot_shards > 1 carves the
    device list into that many groups.
    """
    if devices is None:
        devices = jax.devices()
    if n_cells_shards is None:
        n_cells_shards = len(devices) // n_slot_shards
    n = n_slot_shards * n_cells_shards
    assert n <= len(devices), (n_slot_shards, n_cells_shards, len(devices))
    arr = np.array(devices[:n]).reshape(n_slot_shards, n_cells_shards)
    return Mesh(arr, (slots_axis, cells_axis))
