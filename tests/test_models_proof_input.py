"""End-to-end proof-input generation: device path vs oracle, circuit semantics,
JSON round-trip, CLI."""

import json

import pytest

from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource
from codex_storage_proofs_circuits_tpu.oracle.dataset import GlobalConfig, DataSetConfig
from codex_storage_proofs_circuits_tpu.oracle.sampling import generate_proof_input
from codex_storage_proofs_circuits_tpu.models.proof_input import generate_proof_input_device
from codex_storage_proofs_circuits_tpu.models.circuit import (
    CircuitCheckError,
    check_circuit_semantics,
    verify_proof_input_device,
)

GLOB = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64, block_size=256)
DSET = DataSetConfig(n_slots=3, n_cells=16, n_samples=3,
                     data_src=DataSource("fake", seed=12345))
ENTROPY = 1234567


@pytest.fixture(scope="module")
def pis():
    oracle_pi = generate_proof_input(GLOB, DSET, 1, ENTROPY)
    dev_pi = generate_proof_input_device(GLOB, DSET, 1, ENTROPY)
    return oracle_pi, dev_pi


def test_device_proof_input_matches_oracle(pis):
    o, t = pis
    assert o == t


def test_circuit_semantics_accepts(pis):
    o, _ = pis
    check_circuit_semantics(GLOB, DSET, o)


def test_circuit_semantics_rejects_tampering(pis):
    import dataclasses

    o, _ = pis
    bad = dataclasses.replace(
        o, merkle_paths=[list(p) for p in o.merkle_paths]
    )
    bad.merkle_paths[1][2] ^= 1
    with pytest.raises(CircuitCheckError):
        check_circuit_semantics(GLOB, DSET, bad)

    bad2 = dataclasses.replace(o, data_set_root=o.data_set_root ^ 1)
    with pytest.raises(CircuitCheckError):
        check_circuit_semantics(GLOB, DSET, bad2)


def test_device_witness_verification(pis):
    o, _ = pis
    assert verify_proof_input_device(GLOB, o)
    import dataclasses

    bad = dataclasses.replace(o, cell_data=[list(c) for c in o.cell_data])
    bad.cell_data[0][0] ^= 1
    assert not verify_proof_input_device(GLOB, bad)


def test_json_roundtrip(tmp_path, pis):
    from codex_storage_proofs_circuits_tpu.utils.json_export import (
        export_proof_input,
        load_proof_input,
    )

    o, _ = pis
    f = str(tmp_path / "input.json")
    export_proof_input(f, o)
    with open(f) as fh:
        d = json.load(fh)
    # snarkjs schema: felts as quoted decimal strings (json/bn254.nim:57-74)
    assert set(d) == {
        "dataSetRoot", "entropy", "nCellsPerSlot", "nSlotsPerDataSet",
        "slotIndex", "slotRoot", "slotProof", "cellData", "merklePaths",
    }
    assert isinstance(d["dataSetRoot"], str) and isinstance(d["nCellsPerSlot"], int)
    assert load_proof_input(f) == o


def test_cli_end_to_end(tmp_path):
    from codex_storage_proofs_circuits_tpu.utils.cli import main
    from codex_storage_proofs_circuits_tpu.utils.json_export import load_proof_input

    out = str(tmp_path / "input.json")
    circ = str(tmp_path / "proof_main.circom")
    rc = main([
        "--depth=16", "--maxslots=16", "--cellsize=64", "--blocksize=256",
        "--nslots=3", "--ncells=16", "--nsamples=3", "--seed=12345",
        "--entropy=1234567", "--index=1", "--backend=device", "--check",
        "--field=bn254", f"--output={out}", f"--circom={circ}",
    ])
    assert rc == 0
    pi = load_proof_input(out)
    want = generate_proof_input(GLOB, DSET, 1, ENTROPY)
    assert pi == want
    text = open(circ).read()
    assert "SampleAndProve" in text and "entropy" in text


def test_streaming_proof_input_matches_oracle():
    """Large-slot streaming path == oracle on a small multi-chunk config."""
    from codex_storage_proofs_circuits_tpu.models.proof_input import (
        generate_proof_input_streaming,
    )
    from codex_storage_proofs_circuits_tpu.oracle.dataset import (
        DataSetConfig,
        GlobalConfig,
    )
    from codex_storage_proofs_circuits_tpu.oracle.sampling import (
        generate_proof_input,
    )
    from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource

    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64,
                        block_size=256)
    dset = DataSetConfig(n_slots=3, n_cells=32, n_samples=4,
                         data_src=DataSource("fake", seed=5))
    want = generate_proof_input(glob, dset, 1, 424242)
    got = generate_proof_input_streaming(glob, dset, 1, 424242, chunk_cells=8)
    assert got == want


def test_singleton_dataset_check():
    """n_slots=1: the dataset tree is a single bottom-odd compression and
    the checkers must apply the circuit's maskBitsCorrected[0]=1 fixup
    (merkle.circom:53-62) — regression for a round-3 bug."""
    from codex_storage_proofs_circuits_tpu.models.circuit import (
        check_circuit_semantics,
    )
    from codex_storage_proofs_circuits_tpu.oracle.dataset import (
        DataSetConfig,
        GlobalConfig,
    )
    from codex_storage_proofs_circuits_tpu.oracle.goldilocks import int_to_digest
    from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
        check_proof_input_gl,
        generate_proof_input_gl,
    )
    from codex_storage_proofs_circuits_tpu.oracle.sampling import (
        generate_proof_input,
    )
    from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource

    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64,
                        block_size=256)
    dset = DataSetConfig(n_slots=1, n_cells=32, n_samples=2,
                         data_src=DataSource("fake", seed=5))
    pi = generate_proof_input(glob, dset, 0, 7)
    check_circuit_semantics(glob, dset, pi)
    pig = generate_proof_input_gl("poseidon2", glob, dset, 0, int_to_digest(7))
    check_proof_input_gl("poseidon2", glob, pig)
