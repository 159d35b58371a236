"""Sharded Goldilocks tree builds on the 8-virtual-device CPU mesh vs the
GL oracle (GL device-pipeline parity on the mesh,
like tests/test_parallel_tree.py for BN254)."""

import numpy as np
import pytest
import jax

from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource
from codex_storage_proofs_circuits_tpu.oracle.dataset import (
    GlobalConfig,
    DataSetConfig,
    slot_cfg_from_dataset_cfg,
)
from codex_storage_proofs_circuits_tpu.oracle.goldilocks import compress_fn
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
    calc_slot_tree_gl,
)
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.models import data as D
from codex_storage_proofs_circuits_tpu.models.gl_hashing import encode_cells_gl
from codex_storage_proofs_circuits_tpu.parallel import make_mesh
from codex_storage_proofs_circuits_tpu.parallel.gl_tree import (
    sharded_gl_dataset_build,
)

HASH = "poseidon2"


def _digests(layer) -> list[tuple]:
    arr = np.asarray(jax.device_get(layer))
    f, nl, w = arr.shape
    return [
        tuple(
            int(sum(int(arr[j, l, i]) << (16 * l) for l in range(nl)))
            for j in range(f)
        )
        for i in range(w)
    ]


@pytest.fixture(scope="module")
def mesh_2x4():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(n_cells_shards=4, n_slot_shards=2)


def test_sharded_gl_dataset_build_matches_oracle(mesh_2x4):
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=128, block_size=512)
    dset = DataSetConfig(
        n_slots=3, n_cells=16, n_samples=2, data_src=DataSource("fake", seed=21)
    )
    cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    btd = cfgs[0].cells_per_block.bit_length() - 1

    pad = 4  # multiple of the slots-axis size
    felts = np.stack(
        [
            np.asarray(
                jax.device_get(
                    encode_cells_gl(D.load_slot_cells(cfgs[min(i, dset.n_slots - 1)]))
                )
            )
            for i in range(pad)
        ]
    )
    locs, tops, dlayers = sharded_gl_dataset_build(
        jax.numpy.asarray(felts), mesh_2x4, HASH, btd, n_slots=dset.n_slots
    )

    otrees = [calc_slot_tree_gl(HASH, c) for c in cfgs]
    comp = compress_fn(HASH)
    odset = merkle_tree([t.root for t in otrees], comp)

    # dataset root + full dataset layers (replicated)
    assert _digests(dlayers[-1])[0] == odset.root
    for d, layer in enumerate(dlayers):
        assert _digests(layer) == list(odset.layers[d])

    # per-slot roots and bottom (cell-hash) layers
    for s in range(dset.n_slots):
        assert _digests(tops[-1][s])[0] == otrees[s].root
        got_leaves = _digests(locs[0][s])
        want_leaves = [v for t in otrees[s].mini_trees for v in t.layers[0]]
        assert got_leaves == want_leaves


def test_sharded_gl_proof_input_matches_oracle(mesh_2x4):
    """Full GL mesh pipeline: sharded build -> on-device sampling ->
    collective path/cell gathers -> ProofInputGL; bit-exact vs the oracle
    and accepted by the GL semantics checker."""
    from codex_storage_proofs_circuits_tpu.parallel import sharded_gl_proof_input
    from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
        check_proof_input_gl,
        generate_proof_input_gl,
    )

    glob = GlobalConfig(max_depth=16, max_log2_n_slots=5, cell_size=64, block_size=128)
    dset = DataSetConfig(n_slots=3, n_cells=16, n_samples=4,
                         data_src=DataSource("fake", seed=12345))
    ent = (0xDEADBEEF, 1, 2, 3)

    pig = sharded_gl_proof_input(HASH, glob, dset, 1, ent, mesh_2x4)
    assert pig == generate_proof_input_gl(HASH, glob, dset, 1, ent)
    check_proof_input_gl(HASH, glob, pig)
