"""Device slot-tree construction + Merkle path extraction from stored layers.

The batched device analogue of buildSlotTreeFull (reference/nim/proof_input/src/
gen_input/bn254.nim:21-30): bytes -> 31-byte LE felts -> rate-2 cell hashes
-> depth-b block mini-trees -> slot tree, all as one jitted batched program.
Unlike the reference, trees are built ONCE and their layers kept for path
extraction (the Nim generator rebuilds the slot tree per sample,
gen_input/bn254.nim:57).

Multiple slots of identical shape batch together on the lane axis: pairwise
layer reduction never crosses a slot boundary because every slot's layer
width is a power of two.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax

from ..oracle.slot import SlotConfig
from ..oracle.merkle import MerkleProof
from . import data as D
from . import hashing as H


@dataclass
class DeviceSlotTree:
    """Flat layer stack of one slot's cell->block->slot tree.

    layers[d] is a (width,) numpy object/int array of canonical felts;
    layers[0] are the cell hashes, layers[block_tree_depth] the block roots,
    layers[-1] the slot root (singleton).
    """

    layers: list[np.ndarray]  # canonical values as python-int object arrays
    block_tree_depth: int

    @property
    def root(self) -> int:
        assert len(self.layers[-1]) == 1
        return int(self.layers[-1][0])

    @property
    def depth(self) -> int:
        return len(self.layers) - 1

    @property
    def num_leaves(self) -> int:
        return len(self.layers[0])


def _limbs_to_ints(arr: np.ndarray) -> np.ndarray:
    """(NL, W) uint32 limb planes -> (W,) object array of python ints."""
    nl, w = arr.shape
    acc = np.zeros(w, dtype=object)
    for i in range(nl):
        acc |= arr[i].astype(object) << (16 * i)
    return acc


def build_slot_trees(cfgs: list[SlotConfig]) -> list[DeviceSlotTree]:
    """Build the trees of several identically-shaped slots in one device batch."""
    assert cfgs, "build_slot_trees: no slots"
    cfg0 = cfgs[0]
    n_cells = cfg0.n_cells
    btd = cfg0.cells_per_block.bit_length() - 1
    for c in cfgs:
        assert (c.cell_size, c.block_size, c.n_cells) == (
            cfg0.cell_size,
            cfg0.block_size,
            cfg0.n_cells,
        ), "build_slot_trees: slots must be identically shaped"

    cells = np.concatenate([D.load_slot_cells(c) for c in cfgs], axis=0)
    from ..ops.encode import encode_cells

    n_slots = len(cfgs)
    felts = encode_cells(cells)  # (nfelts, NL, S*n_cells)
    layers_dev = H.slot_tree_from_felts(felts, btd, n_groups=n_slots)
    layers_np = jax.device_get(layers_dev)

    trees: list[DeviceSlotTree] = []
    per_slot_layers: list[list[np.ndarray]] = [[] for _ in range(n_slots)]
    for lyr in layers_np:
        w = lyr.shape[1] // n_slots
        ints = _limbs_to_ints(lyr)
        for s in range(n_slots):
            per_slot_layers[s].append(ints[s * w : (s + 1) * w])
    for s in range(n_slots):
        layers = per_slot_layers[s]
        if len(layers[-1]) != 1:
            raise AssertionError("slot tree did not reduce to a root")
        if n_cells == cfgs[s].cells_per_block:
            # single-block slot: the big tree over one block root is a
            # singleton bottom layer -> one bottom-odd compression
            # (oracle/merkle.py merkle_tree; Merkle.hs:71-74)
            from ..oracle.poseidon2 import keyed_compression

            layers = layers + [
                np.array([keyed_compression(3, int(layers[-1][0]), 0)], dtype=object)
            ]
        trees.append(DeviceSlotTree(layers, btd))
    return trees


def build_slot_tree(cfg: SlotConfig) -> DeviceSlotTree:
    return build_slot_trees([cfg])[0]


def extract_cell_proof(tree: DeviceSlotTree, cell_idx: int) -> MerkleProof:
    """Merged block+slot Merkle path for one cell, from the stored layers.

    Same result as oracle.slot.extract_cell_proof (Slot.hs:181-187): all
    layer widths are powers of two, so the sibling of node j at depth d is
    node j^1 of layer d.
    """
    n = tree.num_leaves
    assert 0 <= cell_idx < n
    if n == 1:
        # singleton bottom: the only path entry is the zero sibling of the
        # bottom-odd compression
        return MerkleProof(0, int(tree.layers[0][0]), [0], 1)
    path = []
    j = cell_idx
    for d in range(tree.depth):
        lyr = tree.layers[d]
        if len(lyr) == 1:
            path.append(0)  # single-block slot's appended odd compression
        else:
            path.append(int(lyr[j ^ 1]))
        j >>= 1
    return MerkleProof(cell_idx, int(tree.layers[0][cell_idx]), path, n)
