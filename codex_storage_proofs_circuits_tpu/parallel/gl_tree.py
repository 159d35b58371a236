"""Sharded Goldilocks Merkle tree builds over a device mesh.

The GL twin of parallel/tree.py (SURVEY.md section 2c): cells shard on the
"cells" mesh axis, each chip sponges its cells and reduces a local digest
subtree, the one-digest-per-chip frontier all-gathers, and the
replicated top layers + dataset tree finish on every chip.  Digest layers
are (4 lanes, 4 limbs, W) uint32 planes; the keyed convention and the flat
cell->block->slot key schedule match models/gl_hashing.py / oracle
(reference/nim/proof_input/src/merkle/goldilocks/poseidon2.nim:14-63).
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

from ..models import gl_hashing as GH
from .mesh import cells_axis, slots_axis
from .tree import _n_dset_layers

NL = 4
F = 4  # felts per digest


def gl_tree_reduce_layers(
    digests: jnp.ndarray,
    hash_fun: str,
    bottom_depths: tuple[int, ...],
    depth_offset: int = 0,
) -> list[jnp.ndarray]:
    """Power-of-two keyed reduction of a (4, 4, W) digest layer, keeping
    every layer (bottom first)."""
    w = digests.shape[2]
    assert w & (w - 1) == 0, "width must be a power of two"
    layers = [digests]
    d = depth_offset
    while layers[-1].shape[2] > 1:
        cur = layers[-1]
        key = 1 if d in bottom_depths else 0
        layers.append(
            GH.compress_digests(hash_fun, key, cur[:, :, 0::2], cur[:, :, 1::2])
        )
        d += 1
    return layers


def gl_tree_reduce_general(leaves: jnp.ndarray, hash_fun: str) -> list[jnp.ndarray]:
    """Keyed Merkle build over digests for ANY width >= 1 (dataset tree):
    odd trailing nodes compress against the zero digest with the odd key;
    a singleton bottom still gets one bottom-odd compression
    (oracle.merkle.merkle_tree semantics)."""
    layers = [leaves]
    bottom = True
    while layers[-1].shape[2] > 1 or bottom:
        cur = layers[-1]
        w = cur.shape[2]
        half = w // 2
        parts = []
        if half:
            parts.append(
                GH.compress_digests(
                    hash_fun,
                    1 if bottom else 0,
                    cur[:, :, 0 : 2 * half : 2],
                    cur[:, :, 1 : 2 * half : 2],
                )
            )
        if w % 2 == 1:
            zero = jnp.zeros((F, NL, 1), jnp.uint32)
            parts.append(
                GH.compress_digests(
                    hash_fun, 3 if bottom else 2, cur[:, :, w - 1 : w], zero
                )
            )
        layers.append(parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=2))
        bottom = False
    return layers


def _gl_slot_tree_shard_body(f_local, hash_fun: str, block_tree_depth: int, n_local: int):
    """Per-chip slot-tree body: local digest layers, frontier
    all-gather, replicated top layers.  Returns (local_layers, top_layers,
    root_digest)."""
    hashes = GH.sponge_digests(hash_fun, f_local)  # (4, 4, w_loc)
    layers = gl_tree_reduce_layers(hashes, hash_fun, (0, block_tree_depth))
    frontier = jax.lax.all_gather(layers[-1], cells_axis, axis=2, tiled=True)
    tops = gl_tree_reduce_layers(
        frontier, hash_fun, (0, block_tree_depth), depth_offset=n_local
    )
    return tuple(layers[:-1]), tuple(tops), tops[-1][:, :, 0]


@functools.partial(
    jax.jit, static_argnames=("mesh", "hash_fun", "block_tree_depth", "n_slots")
)
def _gl_dataset_build_jit(felts_all, mesh, hash_fun: str, block_tree_depth: int, n_slots: int):
    n_cell_chips = mesh.shape[cells_axis]
    n_cells = felts_all.shape[3]
    local_w = n_cells // n_cell_chips
    n_local = local_w.bit_length() - 1
    n_top = n_cell_chips.bit_length() - 1

    def fn(f_local):
        def one_slot(f):
            return _gl_slot_tree_shard_body(f, hash_fun, block_tree_depth, n_local)

        locs, tops, roots = jax.vmap(one_slot)(f_local)
        all_roots = jax.lax.all_gather(roots, slots_axis, axis=0, tiled=True)
        # (n_slots_padded, 4, 4) -> dataset layers over the true slot roots
        dset_leaves = jnp.moveaxis(all_roots[:n_slots], 0, 2)  # (4, 4, n_slots)
        return locs, tops, tuple(gl_tree_reduce_general(dset_leaves, hash_fun))

    in_spec = P(slots_axis, None, None, cells_axis)
    return shard_map(
        fn,
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=(
            tuple(P(slots_axis, None, None, cells_axis) for _ in range(n_local)),
            tuple(P(slots_axis, None, None, None) for _ in range(n_top + 1)),
            tuple(P(None, None, None) for _ in range(_n_dset_layers(n_slots))),
        ),
        check_vma=False,
    )(felts_all)


def sharded_gl_dataset_build(
    felts_all: jnp.ndarray,
    mesh: Mesh,
    hash_fun: str = "poseidon2",
    block_tree_depth: int = 5,
    n_slots: int | None = None,
):
    """Full GL dataset build: slots sharded on "slots", cells on "cells".

    felts_all: (n_slots_padded, nfelts, 4, n_cells) uint32 encoded cells
    (62-byte chunk encoding of models/gl_hashing.encode_cells_gl), with
    n_slots_padded a multiple of the slots-axis size.  Returns
    (local_layers, top_layers, dataset_layers): per-slot digest layers
    stacked on a leading slot axis, and the (odd-width-capable) dataset
    tree over the true slot roots, replicated.
    """
    n_slots_padded = felts_all.shape[0]
    assert n_slots_padded % mesh.shape[slots_axis] == 0
    if n_slots is None:
        n_slots = n_slots_padded
    assert n_slots <= n_slots_padded
    return _gl_dataset_build_jit(felts_all, mesh, hash_fun, block_tree_depth, n_slots)
