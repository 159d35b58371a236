"""Sharded tree builds on the 8-virtual-device CPU mesh vs the oracle."""

import numpy as np
import pytest
import jax

from codex_storage_proofs_circuits_tpu.oracle.slot import (
    DataSource,
    SlotConfig,
    calc_slot_tree,
)
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.oracle.dataset import (
    GlobalConfig,
    DataSetConfig,
    slot_cfg_from_dataset_cfg,
)
from codex_storage_proofs_circuits_tpu.models import data as D
from codex_storage_proofs_circuits_tpu.ops.encode import encode_cells
from codex_storage_proofs_circuits_tpu.ops import limbs as L
from codex_storage_proofs_circuits_tpu.parallel import (
    make_mesh,
    sharded_slot_tree_layers,
    sharded_dataset_build,
)


def _ints(limb_arr):
    return L.unpack(np.asarray(limb_arr))


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()


def test_sharded_slot_tree_matches_oracle(eight_devices):
    cfg = SlotConfig(
        cell_size=64, block_size=128, n_cells=32, n_samples=1,
        data_src=DataSource("fake", seed=11),
    )
    mesh = make_mesh(n_cells_shards=4)
    felts = encode_cells(D.load_slot_cells(cfg))
    btd = cfg.cells_per_block.bit_length() - 1
    local_layers, top_layers = sharded_slot_tree_layers(felts, mesh, btd)

    otree = calc_slot_tree(cfg)
    # bottom layer: all cell hashes
    got_leaves = _ints(local_layers[0])
    want_leaves = [int(v) for t in otree.mini_trees for v in t.layers[0]]
    assert got_leaves == want_leaves
    # root
    assert _ints(top_layers[-1])[0] == otree.root
    # block-roots layer (depth btd) lives in the local stack here
    got_blocks = _ints(local_layers[btd]) if btd < len(local_layers) else _ints(
        top_layers[btd - len(local_layers)]
    )
    assert got_blocks == [int(v) for v in otree.big_tree.layers[0]]


def test_sharded_dataset_build_matches_oracle(eight_devices):
    glob = GlobalConfig(max_depth=32, max_log2_n_slots=8, cell_size=64, block_size=128)
    dset = DataSetConfig(n_slots=3, n_cells=16, n_samples=2,
                         data_src=DataSource("fake", seed=5))
    mesh = make_mesh(n_cells_shards=4, n_slot_shards=2)
    cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    pad = 4  # multiple of the 2-wide slots axis
    felts = np.stack(
        [np.asarray(encode_cells(D.load_slot_cells(cfgs[min(i, 2)])))
         for i in range(pad)]
    )
    locs, tops, dlayers = sharded_dataset_build(
        jax.numpy.asarray(felts), mesh, glob.block_tree_depth, n_slots=dset.n_slots
    )
    otrees = [calc_slot_tree(c) for c in cfgs]
    roots = [t.root for t in otrees]
    for s in range(dset.n_slots):
        assert _ints(tops[-1][s])[0] == roots[s]
    odset = merkle_tree(roots)
    assert _ints(dlayers[-1])[0] == odset.root
    # full dataset tree layer check (odd width: 3 -> 2 -> 1)
    for d, lyr in enumerate(odset.layers):
        assert _ints(dlayers[d]) == [int(v) for v in lyr]


def test_sharded_proof_input_matches_oracle(eight_devices):
    """Full mesh pipeline: sharded dataset build -> on-device sampling ->
    collective path/cell gathers -> ProofInput; bit-exact vs the sequential
    oracle AND accepted by the witness evaluator."""
    from codex_storage_proofs_circuits_tpu.parallel import sharded_proof_input
    from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input
    from codex_storage_proofs_circuits_tpu.models.witness import (
        generate_witness,
        evaluate_witness,
    )

    glob = GlobalConfig(max_depth=16, max_log2_n_slots=5, cell_size=64, block_size=128)
    dset = DataSetConfig(n_slots=3, n_cells=16, n_samples=4,
                         data_src=DataSource("fake", seed=12345))
    mesh = make_mesh(n_cells_shards=4, n_slot_shards=2)
    entropy = 0xDEADBEEF

    pi = sharded_proof_input(glob, dset, 1, entropy, mesh)
    assert pi == generate_proof_input(glob, dset, 1, entropy)
    evaluate_witness(glob, pi, generate_witness(glob, pi))
