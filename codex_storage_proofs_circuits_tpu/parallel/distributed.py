"""Multi-host (multi-process) distribution: jax.distributed + global meshes.

The reference generator is a single-threaded loop over slots
(reference/nim/proof_input/src/gen_input/bn254.nim:26-28); SURVEY.md section
2c makes multi-host execution an obligation: slots are partitioned across
hosts on the "slots" mesh axis (only the per-slot roots cross hosts), and
each slot's cells are sharded across that host's devices on the "cells"
axis.

Usage (one process per host):

    from codex_storage_proofs_circuits_tpu.parallel import distributed as D
    D.initialize("localhost:1234", num_processes=2, process_id=0)
    mesh = D.make_global_mesh()         # slots axis spans hosts
    felts = D.make_global_cell_array(mesh, local_slots, n_slots_padded)
    layers = tree.sharded_dataset_build(felts, mesh, block_tree_depth)

For CPU-backed multi-process testing (tests/test_distributed.py) pass
explicit coordinator/process arguments and a local device count; collectives
run over gloo.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import cells_axis, slots_axis


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_count: int | None = None,
) -> None:
    """Join (or start) the distributed runtime.

    With no arguments, defers to jax.distributed.initialize()'s environment
    autodetection, which needs a cluster environment that announces itself;
    elsewhere pass the coordinator and process arguments explicitly.  For
    CPU multi-process runs local_device_count forces that many virtual CPU
    devices per process and selects the gloo collectives backend.
    """
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def make_global_mesh(
    n_cells_shards: int | None = None, n_slot_shards: int | None = None
) -> Mesh:
    """(slots, cells) mesh over all global devices, hosts on the slots axis.

    Defaults: slots axis = number of processes (each host owns a slot group,
    so the per-layer frontier all-gathers of the tree build stay within a
    host and only the tiny per-slot roots cross hosts), cells axis =
    devices per host.
    jax.devices() orders devices by process index, so a C-order reshape to
    (n_slot_shards, n_cells_shards) keeps each row within one host whenever
    n_cells_shards divides the per-host device count.
    """
    devices = jax.devices()
    if n_slot_shards is None:
        n_slot_shards = jax.process_count()
    if n_cells_shards is None:
        n_cells_shards = len(devices) // n_slot_shards
    n = n_slot_shards * n_cells_shards
    assert n <= len(devices), (n_slot_shards, n_cells_shards, len(devices))
    arr = np.array(devices[:n]).reshape(n_slot_shards, n_cells_shards)
    return Mesh(arr, (slots_axis, cells_axis))


def slot_range_for_process(mesh: Mesh, n_slots_padded: int) -> tuple[int, int]:
    """[start, stop) of the slot axis this process feeds.

    Slots are block-partitioned over the mesh's slots axis; a process owns
    the slot rows of the mesh whose devices are local to it.
    """
    n_groups = mesh.shape[slots_axis]
    assert n_slots_padded % n_groups == 0
    per_group = n_slots_padded // n_groups
    mine = [
        g
        for g in range(n_groups)
        if any(d.process_index == jax.process_index() for d in mesh.devices[g])
    ]
    assert mine, "process owns no mesh row"
    return mine[0] * per_group, (mine[-1] + 1) * per_group


def make_global_cell_array(
    mesh: Mesh, local_slots: np.ndarray, n_slots_padded: int
) -> jax.Array:
    """Assemble the global (n_slots_padded, nfelts, NL, n_cells) cell array
    from this process's slot shard (see slot_range_for_process)."""
    sharding = NamedSharding(mesh, P(slots_axis, None, None, cells_axis))
    global_shape = (n_slots_padded,) + tuple(local_slots.shape[1:])
    return jax.make_array_from_process_local_data(sharding, local_slots, global_shape)
