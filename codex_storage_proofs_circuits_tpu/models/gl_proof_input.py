"""Device-backed Goldilocks proof-input generation.

The GL twin of models/proof_input.py: the same contract as
oracle.goldilocks_pipeline.generate_proof_input_gl
(reference/nim/proof_input/src/gen_input/goldilocks.nim:22-87) with every
slot's cell sponges and tree layers batched on device
(models/gl_hashing.py); sampling and path gathers stay on host over the
returned layer stacks.
"""

from __future__ import annotations

from ..oracle.dataset import DataSetConfig, GlobalConfig, slot_cfg_from_dataset_cfg
from ..oracle.goldilocks import (
    Digest,
    bytes_to_digests_gl,
    compress_fn,
    sample_cell_index_gl,
)
from ..oracle.merkle import extract_proof, merkle_tree
from ..oracle.goldilocks_pipeline import ProofInputGL, _pad_digest_path
from ..oracle.slot import load_cell
from .gl_hashing import build_slot_trees_gl


def generate_proof_input_gl_device(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Digest,
) -> ProofInputGL:
    comp = compress_fn(hash_fun)
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    slot_trees = build_slot_trees_gl(hash_fun, slot_cfgs)  # one device batch
    slot_roots = [t.root for t in slot_trees]

    dset_tree = merkle_tree(slot_roots, comp)
    slot_proof = extract_proof(dset_tree, slot_index)

    our_cfg, our_tree = slot_cfgs[slot_index], slot_trees[slot_index]
    our_root = slot_roots[slot_index]

    idxs = [
        sample_cell_index_gl(hash_fun, entropy, our_root, dset.n_cells, c)
        for c in range(1, dset.n_samples + 1)
    ]

    k = our_cfg.cells_per_block
    cell_data, merkle_paths = [], []
    for idx in idxs:
        block_idx, within = divmod(idx, k)
        bot = extract_proof(our_tree.mini_trees[block_idx], within)
        top = extract_proof(our_tree.big_tree, block_idx)
        merkle_paths.append(
            _pad_digest_path(bot.merkle_path + top.merkle_path, glob.max_depth)
        )
        cell_data.append(bytes_to_digests_gl(load_cell(our_cfg, idx)))

    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )


def generate_proof_input_gl_streaming(
    hash_fun: str,
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: Digest,
    chunk_cells: int = 1 << 13,
) -> ProofInputGL:
    """Large-slot GL proof-input path: streaming chunked tree builds with
    bounded host memory + one batched device path gather (GL twin of
    models/proof_input.generate_proof_input_streaming)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..oracle.merkle import merkle_tree
    from ..oracle.slot import load_cell
    from .gl_hashing import extract_gl_paths_device
    from .streaming import streaming_slot_layers_gl

    def _digest_at(arr: "np.ndarray") -> Digest:
        return tuple(
            int(sum(int(arr[j, l]) << (16 * l) for l in range(4))) for j in range(4)
        )

    comp = compress_fn(hash_fun)
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    roots: list[Digest] = []
    our_layers = None
    for i, cfg in enumerate(slot_cfgs):
        layers = streaming_slot_layers_gl(cfg, hash_fun, chunk_cells)
        roots.append(_digest_at(np.asarray(jax.device_get(layers[-1]))[:, :, 0]))
        if i == slot_index:
            our_layers = layers

    dset_tree = merkle_tree(roots, comp)
    slot_proof = extract_proof(dset_tree, slot_index)

    our_cfg = slot_cfgs[slot_index]
    our_root = roots[slot_index]
    idxs = [
        sample_cell_index_gl(hash_fun, entropy, our_root, dset.n_cells, c)
        for c in range(1, dset.n_samples + 1)
    ]

    paths = extract_gl_paths_device(
        our_layers, jnp.asarray(idxs, jnp.int32), glob.max_depth
    )
    paths_np = np.asarray(jax.device_get(paths))  # (max_depth, 4, 4, S)
    merkle_paths = [
        [_digest_at(paths_np[d, :, :, k]) for d in range(glob.max_depth)]
        for k in range(len(idxs))
    ]
    cell_data = [bytes_to_digests_gl(load_cell(our_cfg, i)) for i in idxs]

    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )
