"""Goldilocks device pipeline vs the GL oracle (encode, trees, proof input).

The GL twin of tests/test_models_slot_tree.py: device-batched 62-byte
encode, rate-8 sponges and keyed tree reduction must equal the scalar
oracle bit-exactly for both hash functions, and the CLI must honor
--backend for --field=goldilocks.
"""

import numpy as np
import pytest

from codex_storage_proofs_circuits_tpu.models.gl_hashing import (
    build_slot_trees_gl,
    encode_cells_gl,
)
from codex_storage_proofs_circuits_tpu.oracle.goldilocks import bytes_to_felts_gl
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
    calc_slot_tree_gl,
    check_proof_input_gl,
    generate_proof_input_gl,
)
from codex_storage_proofs_circuits_tpu.oracle.dataset import (
    DataSetConfig,
    GlobalConfig,
    slot_cfg_from_dataset_cfg,
)
from codex_storage_proofs_circuits_tpu.oracle.goldilocks import int_to_digest
from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig


def test_encode_cells_gl_matches_oracle():
    rng = np.random.default_rng(1)
    for cell_size in (31, 62, 64, 128):
        cells = rng.integers(0, 256, size=(5, cell_size), dtype=np.uint8)
        enc = np.asarray(encode_cells_gl(cells))
        for b in range(cells.shape[0]):
            want = bytes_to_felts_gl(cells[b].tobytes())
            got = [
                int(sum(int(enc[f, l, b]) << (16 * l) for l in range(4)))
                for f in range(enc.shape[0])
            ]
            assert got == want, (cell_size, b)


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_device_slot_tree_matches_oracle(hash_fun):
    cfg = SlotConfig(
        cell_size=64, block_size=256, n_cells=16, n_samples=1,
        data_src=DataSource("fake", seed=5),
    )
    t = build_slot_trees_gl(hash_fun, [cfg])[0]
    o = calc_slot_tree_gl(hash_fun, cfg)
    assert t.root == o.root
    assert [m.layers for m in t.mini_trees] == [m.layers for m in o.mini_trees]
    assert t.big_tree.layers == o.big_tree.layers


def test_device_proof_input_matches_oracle():
    from codex_storage_proofs_circuits_tpu.models.gl_proof_input import (
        generate_proof_input_gl_device,
    )

    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
    dset = DataSetConfig(
        n_slots=3, n_cells=16, n_samples=2, data_src=DataSource("fake", seed=5)
    )
    ent = int_to_digest(1234567)
    got = generate_proof_input_gl_device("poseidon2", glob, dset, 1, ent)
    want = generate_proof_input_gl("poseidon2", glob, dset, 1, ent)
    assert got == want
    check_proof_input_gl("poseidon2", glob, got)


def test_cli_goldilocks_backend_device(tmp_path):
    from codex_storage_proofs_circuits_tpu.utils.cli import main

    out = str(tmp_path / "input_gl.json")
    rc = main([
        "--depth=16", "--maxslots=16", "--cellsize=64", "--blocksize=256",
        "--nslots=3", "--ncells=16", "--nsamples=2", "--seed=12345",
        "--entropy=1234567", "--index=1", "--backend=device", "--check",
        f"--output={out}",  # default field is goldilocks (cli.nim:47-51)
    ])
    assert rc == 0
    import json

    d = json.load(open(out))
    assert "dataSetRoot" in d and "merklePaths" in d
