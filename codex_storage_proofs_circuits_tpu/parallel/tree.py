"""Sharded Merkle tree builds over a device mesh (shard_map + collectives).

Design (SURVEY.md section 2c; the reference is sequential):

  * cells (tree leaves) are sharded on the lane axis across the "cells" mesh
    axis; every chip hashes its cells and reduces its local subtree with the
    batched compression kernel, entirely on-chip;
  * once a layer reaches one node per chip, the frontier (one node per chip)
    is all-gathered and the remaining log2(n_chips) layers are
    computed replicated on every chip — O(n_chips) felts of communication
    total, off the critical path;
  * independent slots shard over the outer "slots" axis; their roots gather
    once at the end for the (tiny, odd-width) dataset tree, computed
    replicated.

Layer keys follow the flat cell->block->slot schedule of
models/hashing.tree_reduce_layers (bottom key at depth 0 and at the
block-tree depth, reference circuit single_cell.circom:41-60).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35 canonical location
    from jax import shard_map as _sm

    shard_map = _sm.shard_map if hasattr(_sm, "shard_map") else _sm
except (ImportError, AttributeError):  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..ops import limbs as L
from ..models import hashing as H
from .mesh import cells_axis, slots_axis

NL = L.NL


def _key_at(depth: int, block_tree_depth: int) -> int:
    return 1 if depth in (0, block_tree_depth) else 0


def _local_layers(felts_local: jnp.ndarray, block_tree_depth: int) -> list[jnp.ndarray]:
    """Hash local cells and reduce the local subtree to one node per chip."""
    hashes = H.hash_cells_mont(felts_local)
    return H.tree_reduce_layers(hashes, bottom_depths=(0, block_tree_depth))


def _slot_tree_shard_body(f_local, block_tree_depth: int, n_local: int):
    """Per-chip slot-tree body shared by the single-slot and dataset builds:
    local subtree layers, frontier all-gather, replicated top layers.

    Returns (local_layers_canonical, top_layers_canonical, root_mont)."""
    layers = _local_layers(f_local, block_tree_depth)
    frontier = jax.lax.all_gather(layers[-1], cells_axis, axis=1, tiled=True)
    tops = H.tree_reduce_layers(
        frontier, bottom_depths=(0, block_tree_depth), depth_offset=n_local
    )
    return (
        tuple(H.from_mont(x) for x in layers[:-1]),
        tuple(H.from_mont(x) for x in tops),
        tops[-1][:, 0],
    )


def sharded_slot_tree_layers(
    felts: jnp.ndarray, mesh: Mesh, block_tree_depth: int
) -> tuple[list[jnp.ndarray], list[jnp.ndarray]]:
    """One slot's tree, cells sharded over the mesh "cells" axis.

    felts: (nfelts, NL, n_cells) canonical encoded cells (n_cells a power of
    two, divisible by the cells-axis size).  Returns (local_layers,
    top_layers), all canonical: local_layers[d] is the global layer at depth
    d, lane-sharded; top_layers start at depth log2(n_cells/n_chips) with
    the gathered frontier, replicated.
    """
    n_chips = mesh.shape[cells_axis]
    n_cells = felts.shape[2]
    assert n_cells % n_chips == 0
    local_w = n_cells // n_chips
    assert local_w & (local_w - 1) == 0, "per-chip width must be a power of two"
    n_local = local_w.bit_length() - 1
    n_top = n_chips.bit_length() - 1
    assert 1 << n_top == n_chips, "n_chips must be a power of two"

    def fn(f_local):
        locals_c, tops_c, _root = _slot_tree_shard_body(
            f_local, block_tree_depth, n_local
        )
        return locals_c, tops_c

    spec_in = P(None, None, cells_axis)
    fn_sharded = shard_map(
        fn,
        mesh=mesh,
        in_specs=(spec_in,),
        out_specs=(
            tuple(P(None, cells_axis) for _ in range(n_local)),
            tuple(P(None, None) for _ in range(n_top + 1)),
        ),
        check_vma=False,
    )
    local_layers, top_layers = jax.jit(fn_sharded)(felts)
    return list(local_layers), list(top_layers)


@functools.partial(
    jax.jit, static_argnames=("mesh", "block_tree_depth", "n_slots")
)
def _dataset_build_jit(felts_all, mesh, block_tree_depth: int, n_slots: int):
    """shard_map body for sharded_dataset_build (see below)."""
    n_cell_chips = mesh.shape[cells_axis]
    n_slot_chips = mesh.shape[slots_axis]
    n_cells = felts_all.shape[3]
    local_w = n_cells // n_cell_chips
    n_local = local_w.bit_length() - 1
    n_top = n_cell_chips.bit_length() - 1

    def fn(f_local):
        # f_local: (n_slots/n_slot_chips, nfelts, NL, n_cells/n_cell_chips);
        # from_mont happens inside the body while the limb axis still leads
        # (vmap adds the slot axis outside)
        def one_slot(f):
            return _slot_tree_shard_body(f, block_tree_depth, n_local)

        locs, tops, roots_mont = jax.vmap(one_slot)(f_local)
        all_roots = jax.lax.all_gather(
            roots_mont, slots_axis, axis=0, tiled=True
        )  # (n_slots_padded, NL) replicated
        dset_layers = H.tree_reduce_general(all_roots[:n_slots].T)
        return (locs, tops, tuple(H.from_mont(x) for x in dset_layers))

    in_spec = P(slots_axis, None, None, cells_axis)
    return shard_map(
        fn,
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=(
            tuple(P(slots_axis, None, cells_axis) for _ in range(n_local)),
            tuple(P(slots_axis, None, None) for _ in range(n_top + 1)),
            tuple(P(None, None) for _ in range(_n_dset_layers(n_slots))),
        ),
        check_vma=False,
    )(felts_all)


def _n_dset_layers(n_slots: int) -> int:
    """Static layer count of tree_reduce_general for n_slots leaves."""
    n, w, bottom = 1, n_slots, True
    while w > 1 or bottom:
        w = (w + 1) // 2
        bottom = False
        n += 1
    return n


def sharded_dataset_build(
    felts_all: jnp.ndarray, mesh: Mesh, block_tree_depth: int, n_slots: int | None = None
):
    """Full dataset build: slots sharded on "slots", cells on "cells".

    felts_all: (n_slots_padded, nfelts, NL, n_cells) canonical encoded cells,
    n_slots_padded a multiple of the slots-axis size (pad with anything —
    the dataset tree only uses the first `n_slots` roots).  Returns
    (local_layers, top_layers, dataset_layers): per-slot layers stacked on a
    leading slot axis, and the (odd-width-capable) dataset tree over the
    true slot roots, replicated.
    """
    n_slots_padded = felts_all.shape[0]
    assert n_slots_padded % mesh.shape[slots_axis] == 0
    if n_slots is None:
        n_slots = n_slots_padded
    assert n_slots <= n_slots_padded
    return _dataset_build_jit(felts_all, mesh, block_tree_depth, n_slots)
