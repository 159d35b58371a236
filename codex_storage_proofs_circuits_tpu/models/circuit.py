"""Witness / constraint evaluation for the SampleAndProve statement.

Evaluates the reference circuit's semantics
(circuit/codex/sample_cells.circom:58-148, single_cell.circom:30-73,
merkle.circom:44-114) against a generated ProofInput — i.e. re-derives every
`===` assertion the Groth16 circuit would enforce:

  1. dataset-level inclusion: the slot root reconstructs the dataset root
     along slotProof under the variable-depth masked path
     (sample_cells.circom:95-109);
  2. per sample: the cell index is the low log2(nCells) bits of
     H(entropy|slotRoot|counter) (CalculateCellIndexBits,
     sample_cells.circom:23-48 with the <r range semantics of
     extract_bits.circom:17-40);
  3. per sample: the cell data hashes (rate-2 sponge over exactly
     nFieldElemsPerCell felts) and re-walks the two-stage merged path —
     depth-b block tree then variable-depth slot tree — to the slot root
     (single_cell.circom:41-71).

Two implementations with identical verdicts: a scalar host checker
(check_circuit_semantics) and a batched device evaluator
(verify_proof_input_device) that walks every sample's Merkle path in one
lax.scan of keyed compressions — witness checking as a device pipeline stage.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..fields.bn254 import P
from ..oracle.poseidon2 import sponge2
from ..oracle.slot import hash_cell_felts
from ..oracle.merkle import MerkleProof, reconstruct_root
from ..oracle.sampling import ProofInput
from ..oracle.dataset import GlobalConfig, DataSetConfig
from ..ops import limbs as L
from ..ops import poseidon2_jnp as P2
from . import hashing as H

NL = L.NL


class CircuitCheckError(AssertionError):
    """A `===` assertion of the circuit semantics failed."""


def _ceiling_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 0 else -1


def check_circuit_semantics(
    glob: GlobalConfig, dset: DataSetConfig, pi: ProofInput
) -> None:
    """Scalar host evaluation of every circuit assertion; raises on failure."""
    n_cells = pi.n_cells_per_slot
    n_slots = pi.n_slots_per_dataset
    log2_n_cells = _ceiling_log2(n_cells)
    assert 1 << log2_n_cells == n_cells, "nCells must be a power of two"
    btd = glob.block_tree_depth
    nfe = glob.n_field_elems_per_cell

    if len(pi.slot_proof) != glob.max_log2_n_slots:
        raise CircuitCheckError("slotProof not padded to maxLog2NSlots")

    # (1) dataset-level inclusion (sample_cells.circom:95-109)
    # singleton-dataset fixup: the circuit forces one bottom-odd step even
    # when ceilingLog2(nSlots) == 0 (merkle.circom:53-62 maskBitsCorrected)
    ds_depth = max(1, _ceiling_log2(n_slots))
    ds_proof = MerkleProof(
        pi.slot_index, pi.slot_root, list(pi.slot_proof[:ds_depth]), n_slots
    )
    if reconstruct_root(ds_proof) != pi.data_set_root:
        raise CircuitCheckError("recRoot === dataSetRoot failed")

    for k, (cdata, path) in enumerate(zip(pi.cell_data, pi.merkle_paths)):
        counter = k + 1  # counter = cnt + 1 (sample_cells.circom:138)
        if len(cdata) != nfe:
            raise CircuitCheckError(f"sample {k}: cellData length != {nfe}")
        if len(path) != glob.max_depth:
            raise CircuitCheckError(f"sample {k}: path not padded to maxDepth")
        if any(not (0 <= v < P) for v in cdata):
            raise CircuitCheckError(f"sample {k}: cellData felt out of range")

        # (2) sampled index (CalculateCellIndexBits)
        idx = sponge2([pi.entropy, pi.slot_root, counter]) & (n_cells - 1)

        # (3) two-stage path walk (ProveSingleCell)
        cell_hash = hash_cell_felts(cdata)
        bot = MerkleProof(idx & ((1 << btd) - 1), cell_hash, list(path[:btd]), 1 << btd)
        block_root = reconstruct_root(bot)
        top = MerkleProof(
            idx >> btd, block_root, list(path[btd:log2_n_cells]), n_cells >> btd
        )
        if reconstruct_root(top) != pi.slot_root:
            raise CircuitCheckError(f"sample {k}: recRoot === slotRoot failed")


# ---------------------------------------------------------------------------
# Batched device evaluation.


def _masked_path_walk(
    leaves_mont: jnp.ndarray,  # (NL, B) Montgomery leaf values
    paths_mont: jnp.ndarray,  # (max_depth, NL, B) Montgomery siblings
    index_bits: jnp.ndarray,  # (max_depth, B) uint32 0/1, LE bit per depth
    depth_mask: jnp.ndarray,  # (max_depth, B) uint32 1 while depth < real depth
    bottom_depths: tuple[int, ...],
    block_tree_depth: int,
) -> jnp.ndarray:
    """Variable-depth keyed Merkle walk, the device twin of
    RootFromMerklePath's maskBits layer-select (merkle.circom:106-113) for
    power-of-two trees (no odd nodes on sampled slot paths).
    """
    max_depth, b = index_bits.shape
    # per-depth Montgomery key column: bottom key at the listed depths
    # (callers with odd nodes pass explicit per-depth/lane key planes)
    keys = np.zeros((max_depth, NL, 1), np.uint32)
    for d in range(max_depth):
        keys[d] = P2.KEY_MONT[1 if d in bottom_depths else 0]
    keys = jnp.asarray(np.broadcast_to(keys, (max_depth, NL, b)).copy())
    return _masked_path_walk_keys(leaves_mont, paths_mont, index_bits, depth_mask, keys)


def _masked_path_walk_keys(
    leaves_mont: jnp.ndarray,
    paths_mont: jnp.ndarray,
    index_bits: jnp.ndarray,
    depth_mask: jnp.ndarray,
    keys: jnp.ndarray,  # (max_depth, NL, B) Montgomery key planes
) -> jnp.ndarray:

    def body(h, xs):
        sib, bit, mask, key = xs  # bit/mask are (1, B): broadcast over limbs
        x = jnp.where(bit.astype(bool), sib, h)
        y = jnp.where(bit.astype(bool), h, sib)
        out = H.permute(jnp.stack([x, y, key]))[0]
        h = jnp.where(mask.astype(bool), out, h)
        return h, None

    h, _ = jax.lax.scan(
        body,
        leaves_mont,
        (paths_mont, index_bits[:, None, :], depth_mask[:, None, :], keys),
    )
    return h


def verify_proof_input_device(glob: GlobalConfig, pi: ProofInput) -> bool:
    """Full device re-derivation of the circuit assertions.

    Everything per-sample is batched device work: the nSamples index sponges
    (H(entropy|slotRoot|counter), low-bit extraction on limb planes), the
    nSamples cell hashes as one sponge batch, the nSamples two-stage path
    walks as one scan of keyed compressions — plus the dataset-level
    inclusion walk (odd-capable key schedule).  The host only packs inputs
    and reads back one boolean per check.
    """
    n_cells = pi.n_cells_per_slot
    log2_n_cells = _ceiling_log2(n_cells)
    btd = glob.block_tree_depth
    n = len(pi.cell_data)
    max_depth = glob.max_depth

    # (1) sampled indices: one batched sponge over (entropy, slotRoot, k+1)
    triples = jnp.stack(
        [
            L.pack([pi.entropy] * n),
            L.pack([pi.slot_root] * n),
            L.pack(list(range(1, n + 1))),
        ]
    )  # (3, NL, n)
    hash_can = L.from_mont(
        H.sponge2_scan(P2.pad_felts_rate2(H.to_mont_stack(triples)))
    )  # (NL, n) canonical
    assert log2_n_cells <= 32
    idx = hash_can[0] + (hash_can[1] << 16)  # low 32 bits, exact in uint32
    idx = idx & np.uint32(n_cells - 1)
    d_iota = jnp.arange(max_depth, dtype=jnp.uint32)[:, None]
    bits = (idx[None, :] >> d_iota) & jnp.uint32(1)  # (max_depth, n)
    mask = jnp.broadcast_to(
        (d_iota < log2_n_cells).astype(jnp.uint32), (max_depth, n)
    )

    # (2) batched cell hashes
    felts = np.array(pi.cell_data, dtype=object).T  # (nfe, n)
    cells = jnp.stack([L.pack(row) for row in felts])  # (nfe, NL, n)
    leaf_mont = H.sponge2_scan(P2.pad_felts_rate2(H.to_mont_stack(cells)))

    # (3) batched masked two-stage path walk
    paths = jnp.stack(
        [L.pack([pi.merkle_paths[k][d] for k in range(n)]) for d in range(max_depth)]
    )  # (max_depth, NL, n)
    paths_mont = H.to_mont_stack(paths)
    roots_mont = _masked_path_walk(leaf_mont, paths_mont, bits, mask, (0, btd), btd)
    want_root = L.to_mont(L.pack([pi.slot_root] * n))
    samples_ok = jnp.all(roots_mont == want_root)

    # (4) dataset-level inclusion (sample_cells.circom:95-109): one walk with
    # the odd-capable key schedule of the keyed convention (merkle.circom
    # key = bottom + 2*odd; odd iff the prefix equals the last-index prefix
    # and the path bit is 0)
    n_slots = pi.n_slots_per_dataset
    # singleton dataset tree still walks one bottom-odd compression
    # (maskBitsCorrected[0] = 1, merkle.circom:53-62)
    ds_depth = max(1, _ceiling_log2(n_slots))
    si = pi.slot_index
    keys_np = np.zeros((ds_depth, NL, 1), np.uint32)
    j, last = si, n_slots - 1
    for d in range(ds_depth):
        # odd node: last in its row with no right sibling (merkle.nim:51-74)
        odd = 1 if (j == (last >> d) and (j & 1) == 0) else 0
        keys_np[d] = P2.KEY_MONT[(1 if d == 0 else 0) + 2 * odd]
        j >>= 1
    ds_bits = np.array([[(si >> d) & 1] for d in range(ds_depth)], np.uint32)
    ds_mask = np.ones((ds_depth, 1), np.uint32)
    ds_path = jnp.stack(
        [L.pack([pi.slot_proof[d]]) for d in range(ds_depth)]
    )
    ds_root_mont = _masked_path_walk_keys(
        L.to_mont(L.pack([pi.slot_root])),
        H.to_mont_stack(ds_path),
        jnp.asarray(ds_bits),
        jnp.asarray(ds_mask),
        jnp.asarray(np.broadcast_to(keys_np, (ds_depth, NL, 1)).copy()),
    )
    ds_ok_dev = jnp.all(ds_root_mont == L.to_mont(L.pack([pi.data_set_root])))
    return bool(jax.device_get(jnp.logical_and(samples_ok, ds_ok_dev)))
