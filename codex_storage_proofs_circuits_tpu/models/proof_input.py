"""Device-backed proof-input generation (L4/L6 compute path).

Same contract as oracle.sampling.generate_proof_input
(reference/nim/proof_input/src/gen_input/bn254.nim:35-74, Sampling.hs:62-89)
but with the hot work — cell hashing and tree construction for every slot —
batched on device.  Sampling hashes (nSamples sponge2 calls over 3 felts) and
Merkle-path gathers (nSamples x depth scalars) are negligible and stay on
host, reading the device-built layer stacks.
"""

from __future__ import annotations

import numpy as np

from ..oracle.merkle import merkle_tree, extract_proof
from ..oracle.slot import cell_data_to_field_elements
from ..oracle.sampling import ProofInput, sample_cell_indices
from ..oracle.dataset import GlobalConfig, DataSetConfig, slot_cfg_from_dataset_cfg
from . import data as D
from .slot_tree import build_slot_trees, extract_cell_proof


def generate_proof_input_device(
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: int,
) -> ProofInput:
    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    trees = build_slot_trees(slot_cfgs)  # one batched device build for all slots
    slot_roots = [t.root for t in trees]

    dset_tree = merkle_tree(slot_roots)
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)

    our_cfg = slot_cfgs[slot_index]
    our_tree = trees[slot_index]
    our_root = slot_roots[slot_index]

    idxs = sample_cell_indices(entropy, our_root, dset.n_cells, dset.n_samples)

    cells = D.load_cells(our_cfg, np.asarray(idxs))
    cell_data = [cell_data_to_field_elements(cells[k].tobytes()) for k in range(len(idxs))]
    merkle_paths = [
        extract_cell_proof(our_tree, i).padded(glob.max_depth).merkle_path for i in idxs
    ]

    return ProofInput(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )


def generate_proof_input_streaming(
    glob: GlobalConfig,
    dset: DataSetConfig,
    slot_index: int,
    entropy: int,
    chunk_cells: int = 1 << 13,
) -> ProofInput:
    """Large-slot proof-input path: streaming chunked tree builds (bounded
    host memory, models/streaming.py) + one batched device path gather.

    Identical output to generate_proof_input_device / the oracle; usable at
    1 GB slots and beyond, where materializing every cell of
    every slot host-side (build_slot_trees) is not.  Non-sampled slots keep
    only their root; the sampled slot keeps its device layer stack for the
    path gather (~2 x 64 B x n_cells of device memory).
    """
    import jax
    import jax.numpy as jnp

    from ..ops import limbs as L
    from . import hashing as H
    from .streaming import streaming_slot_layers

    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    roots: list[int] = []
    our_layers = None
    for i, cfg in enumerate(slot_cfgs):
        layers = streaming_slot_layers(cfg, chunk_cells)
        roots.append(L.unpack(layers[-1])[0])
        if i == slot_index:
            our_layers = layers

    dset_tree = merkle_tree(roots)
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)

    our_cfg = slot_cfgs[slot_index]
    our_root = roots[slot_index]
    idxs = sample_cell_indices(entropy, our_root, dset.n_cells, dset.n_samples)

    paths = H.extract_paths_device(
        our_layers, jnp.asarray(idxs, jnp.int32), glob.max_depth
    )
    paths_np = np.asarray(jax.device_get(paths))  # (max_depth, NL, S)
    merkle_paths = [
        L.unpack(paths_np[:, :, k].T) for k in range(len(idxs))
    ]

    cells = D.load_cells(our_cfg, np.asarray(idxs))
    cell_data = [
        cell_data_to_field_elements(cells[k].tobytes()) for k in range(len(idxs))
    ]
    return ProofInput(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )
