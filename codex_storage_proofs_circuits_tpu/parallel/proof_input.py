"""Mesh-sharded end-to-end proof-input generation (both fields).

Completes the SURVEY §2c "per-host partitioned sampled-witness batches"
obligation: after the sharded dataset build (parallel/tree.py /
parallel/gl_tree.py), the *sampling hashes*, the *Merkle path gathers* and
the *cell-data gathers* also run on the mesh —

  * the sampling sponge (H(entropy | slotRoot | counter), counters
    1..nSamples batched on the lane axis; sample/bn254.nim:16-27,
    sample/goldilocks.nim:18-38) executes on device from the device-resident
    slot root, so sampled indices never round-trip through the host;
  * path gathers read the *sharded* layer stacks via
    models.hashing.extract_paths_device / models.gl_hashing.
    extract_gl_paths_device under jit: XLA partitions the takes across the
    "cells" mesh axis (collective gathers);
  * sampled cell data gathers from the sharded encoded-cell array the same
    way.

Only the tiny replicated artifacts (slot roots, dataset layers, the
nSamples gathered paths) come back to the host for ProofInput assembly —
O(nSamples * maxDepth) field elements, independent of slot size.

Bit-exactness vs the sequential oracle (oracle.sampling.generate_proof_input
/ oracle.goldilocks_pipeline.generate_proof_input_gl) is enforced by
tests/test_parallel_tree.py, tests/test_gl_parallel_tree.py and
__graft_entry__.dryrun_multichip, which also run the witness evaluator on
the mesh-built bundles.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..fields import bn254
from ..ops import limbs as L
from ..ops import poseidon2_jnp as P2
from ..ops.encode import encode_cells
from ..models import hashing as H
from ..models import data as D
from ..models.gl_hashing import encode_cells_gl, extract_gl_paths_device, sponge_digests
from ..oracle.merkle import MerkleTree, extract_proof
from ..oracle.sampling import ProofInput
from ..oracle.dataset import GlobalConfig, DataSetConfig, slot_cfg_from_dataset_cfg
from ..oracle.goldilocks_pipeline import ProofInputGL, _pad_digest_path
from .mesh import slots_axis
from .tree import sharded_dataset_build
from .gl_tree import sharded_gl_dataset_build

NL = L.NL


# ---------------------------------------------------------------------------
# Device-side sampling (BN254): sponge2([entropy, slotRoot, counter]) low bits.


def _sample_indices_dev(entropy_mont, counters_mont, root_std, log2n: int):
    """Batched on-device cell-index sampling.

    entropy_mont: (NL, 1) Montgomery limbs; counters_mont: (NL, S) Montgomery
    limbs of counters 1..S; root_std: (NL,) canonical standard-form slot
    root.  The sponge2 of [entropy, root, counter] is two permutations; the
    first block (entropy, root) is counter-independent, so it runs once and
    the batch only spans the second absorb.  Index = low log2n bits of the
    squeezed lane's standard form (extractLowBits, types/bn254.nim:47-59).
    """
    s = counters_mont.shape[1]
    root_mont = H.to_mont(root_std[:, None])  # (NL, 1)
    iv = jnp.asarray(P2.SPONGE2_IV_MONT)
    st1 = H.permute(
        jnp.stack([jnp.broadcast_to(entropy_mont, (NL, 1)), root_mont, iv])
    )
    one_mont = jnp.asarray(P2.KEY_MONT[1])  # mont(1): the 10* padding felt
    x = L.add_mod(jnp.broadcast_to(st1[0], (NL, s)), counters_mont)
    y = L.add_mod(
        jnp.broadcast_to(st1[1], (NL, s)), jnp.broadcast_to(one_mont, (NL, s))
    )
    z = jnp.broadcast_to(st1[2], (NL, s))
    h = H.from_mont(H.permute(jnp.stack([x, y, z]))[0])  # (NL, S) canonical
    assert log2n <= 32
    idx = (h[0] | (h[1] << 16)) & jnp.uint32((1 << log2n) - 1)
    return idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_depth", "log2n"))
def _sample_gather_bn254(
    entropy_mont, counters_mont, slot_layers, felts_slot, max_depth: int, log2n: int
):
    """Sample indices on device, then gather sibling paths + cell data from
    the (sharded) slot layer stack and encoded-cell array."""
    root = slot_layers[-1][:, 0]
    idx = _sample_indices_dev(entropy_mont, counters_mont, root, log2n)
    paths = H.extract_paths_device(list(slot_layers), idx, max_depth)
    cells = jnp.take(felts_slot, idx, axis=2)  # (nfelts, NL, S)
    return idx, paths, cells


def sharded_proof_input(
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: int,
    mesh: Mesh,
) -> ProofInput:
    """Full BN254 proof input with every compute stage on the mesh.

    Same contract as oracle.sampling.generate_proof_input
    (gen_input/bn254.nim:35-74), slots sharded on the "slots" mesh axis and
    cells on "cells"."""
    n_shards = mesh.shape[slots_axis]
    n_slots_padded = -(-dset.n_slots // n_shards) * n_shards
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    felts_all = np.stack(
        [
            np.asarray(
                jax.device_get(
                    encode_cells(D.load_slot_cells(slot_cfgs[min(i, dset.n_slots - 1)]))
                )
            )
            for i in range(n_slots_padded)
        ]
    )
    locs, tops, dlayers = sharded_dataset_build(
        jnp.asarray(felts_all), mesh, glob.block_tree_depth, n_slots=dset.n_slots
    )

    # dataset tree (tiny, replicated) -> oracle MerkleTree for path extraction
    dset_tree = MerkleTree(
        [L.unpack(np.asarray(jax.device_get(l))) for l in dlayers]
    )
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)

    log2n = (dset.n_cells - 1).bit_length()
    slot_layers = tuple(l[slot_index] for l in locs) + tuple(
        l[slot_index] for l in tops
    )
    entropy_mont = L.pack([bn254.to_mont(entropy)])
    counters_mont = L.pack([bn254.to_mont(c) for c in range(1, dset.n_samples + 1)])
    idx, paths, cells = _sample_gather_bn254(
        entropy_mont,
        counters_mont,
        slot_layers,
        jnp.asarray(felts_all[slot_index]),
        glob.max_depth,
        log2n,
    )
    paths_np = np.asarray(jax.device_get(paths))  # (max_depth, NL, S)
    cells_np = np.asarray(jax.device_get(cells))  # (nfelts, NL, S)
    s = dset.n_samples
    merkle_paths = [L.unpack(paths_np[:, :, k].T) for k in range(s)]
    cell_data = [L.unpack(cells_np[:, :, k].T) for k in range(s)]
    root = L.unpack(np.asarray(jax.device_get(slot_layers[-1])))[0]

    return ProofInput(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )


# ---------------------------------------------------------------------------
# Goldilocks twin.


def _sample_indices_dev_gl(hash_fun: str, entropy_d, counters_f, root_d, log2n: int):
    """Batched GL sampling: rate-8 digest of [entropy(4) | root(4) |
    intToDigest(counter)(4)] felts; index = low log2n bits of lane-0 felt
    (sample/goldilocks.nim:18-38, types/goldilocks.nim:30-36, k <= 56)."""
    s = counters_f.shape[1]
    felts = jnp.concatenate(
        [
            jnp.broadcast_to(entropy_d, (4, 4, s)),
            jnp.broadcast_to(root_d[:, :, None], (4, 4, s)),
            counters_f[None],  # (1, 4, S)
            jnp.zeros((3, 4, s), jnp.uint32),
        ],
        axis=0,
    )  # (12, 4, S)
    h = sponge_digests(hash_fun, felts)  # (4, 4, S)
    assert log2n <= 32
    idx = (h[0, 0] | (h[0, 1] << 16)) & jnp.uint32((1 << log2n) - 1)
    return idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("hash_fun", "max_depth", "log2n"))
def _sample_gather_gl(
    hash_fun: str,
    entropy_d,
    counters_f,
    slot_layers,
    felts_slot,
    max_depth: int,
    log2n: int,
):
    root = slot_layers[-1][:, :, 0]
    idx = _sample_indices_dev_gl(hash_fun, entropy_d, counters_f, root, log2n)
    paths = extract_gl_paths_device(list(slot_layers), idx, max_depth)
    cells = jnp.take(felts_slot, idx, axis=2)  # (nfelts, 4, S)
    return idx, paths, cells


def _digest_at(arr: np.ndarray) -> tuple:
    return tuple(
        int(sum(int(arr[j, l]) << (16 * l) for l in range(4))) for j in range(4)
    )


def _digest_planes(d) -> np.ndarray:
    out = np.zeros((4, 4, 1), np.uint32)
    for j, v in enumerate(d):
        for l in range(4):
            out[j, l, 0] = (int(v) >> (16 * l)) & 0xFFFF
    return out


def sharded_gl_proof_input(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: tuple,
    mesh: Mesh,
) -> ProofInputGL:
    """Full Goldilocks proof input with every compute stage on the mesh
    (gen_input/goldilocks.nim:22-87 contract)."""
    n_shards = mesh.shape[slots_axis]
    n_slots_padded = -(-dset.n_slots // n_shards) * n_shards
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    felts_all = np.stack(
        [
            np.asarray(
                jax.device_get(
                    encode_cells_gl(D.load_slot_cells(slot_cfgs[min(i, dset.n_slots - 1)]))
                )
            )
            for i in range(n_slots_padded)
        ]
    )
    locs, tops, dlayers = sharded_gl_dataset_build(
        jnp.asarray(felts_all), mesh, hash_fun, glob.block_tree_depth,
        n_slots=dset.n_slots,
    )

    from ..models.gl_hashing import _digests_np

    dset_tree = MerkleTree(
        [_digests_np(np.asarray(jax.device_get(l))) for l in dlayers]
    )
    slot_proof = extract_proof(dset_tree, slot_index)

    log2n = (dset.n_cells - 1).bit_length()
    slot_layers = tuple(l[slot_index] for l in locs) + tuple(
        l[slot_index] for l in tops
    )
    counters_f = np.zeros((4, dset.n_samples), np.uint32)
    for c in range(1, dset.n_samples + 1):
        for l in range(4):
            counters_f[l, c - 1] = (c >> (16 * l)) & 0xFFFF
    idx, paths, cells = _sample_gather_gl(
        hash_fun,
        jnp.asarray(_digest_planes(entropy)),
        jnp.asarray(counters_f),
        slot_layers,
        jnp.asarray(felts_all[slot_index]),
        glob.max_depth,
        log2n,
    )
    paths_np = np.asarray(jax.device_get(paths))  # (max_depth, 4, 4, S)
    cells_np = np.asarray(jax.device_get(cells))  # (nfelts, 4, S)
    s = dset.n_samples
    merkle_paths = [
        [_digest_at(paths_np[d, :, :, k]) for d in range(glob.max_depth)]
        for k in range(s)
    ]
    nf = cells_np.shape[0]
    cell_data = []
    for k in range(s):
        felts = [
            int(sum(int(cells_np[f, l, k]) << (16 * l) for l in range(4)))
            for f in range(nf)
        ]
        cell_data.append(
            [tuple(felts[i : i + 4]) for i in range(0, nf, 4)]
        )
    root = _digest_at(np.asarray(jax.device_get(slot_layers[-1]))[:, :, 0])

    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )
