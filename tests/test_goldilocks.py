"""Goldilocks track: oracle self-consistency + device-kernel bit-exactness.

The upstream nim-goldilocks-hash pin is not vendored in the reference, so
there are no external vectors to freeze (see fields/goldilocks.py); these
tests hold the batched device kernels (ops/goldilocks_jnp.py) bit-exact to the
scalar oracle (oracle/goldilocks.py) and exercise the full digest pipeline.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from codex_storage_proofs_circuits_tpu.fields.goldilocks import P_GL, T
from codex_storage_proofs_circuits_tpu.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu.oracle.dataset import (
    DataSetConfig,
    GlobalConfig,
)
from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
    check_proof_input_gl,
    generate_proof_input_gl,
    proof_input_gl_to_dict,
)
from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_tree
from codex_storage_proofs_circuits_tpu.ops import goldilocks_jnp as K

RNG = np.random.default_rng(7)


def rand_felts(n):
    return [int(v) % P_GL for v in RNG.integers(0, 1 << 63, n) * 2 + 1]


# ---------------------------------------------------------------------------
# Field arithmetic kernels.


def test_gl_mul_matches_bigint():
    a, b = rand_felts(64), rand_felts(64)
    got = K.unpack(K.gl_mul(K.pack(a), K.pack(b)))
    assert got == [(x * y) % P_GL for x, y in zip(a, b)]


def test_gl_mul_edge_cases():
    edge = [0, 1, P_GL - 1, P_GL - 2, (1 << 32) - 1, 1 << 32, (1 << 63) + 5]
    for x in edge:
        for y in edge:
            assert K.unpack(K.gl_mul(K.pack([x]), K.pack([y])))[0] == (x * y) % P_GL


def test_gl_add():
    a, b = rand_felts(32), rand_felts(32)
    got = K.unpack(K.gl_add(K.pack(a), K.pack(b)))
    assert got == [(x + y) % P_GL for x, y in zip(a, b)]


# ---------------------------------------------------------------------------
# Permutations: device vs scalar oracle.


def _states(batch):
    return [rand_felts(T) for _ in range(batch)]


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_permutation_batch_vs_oracle(hash_fun):
    sts = _states(5)
    dev = jnp.stack([K.pack([s[i] for s in sts]) for i in range(T)])
    out = K.PERMUTATIONS[hash_fun](dev)
    for lane in range(T):
        got = K.unpack(out[lane])
        want = [OG.PERMUTATIONS[hash_fun](s)[lane] for s in sts]
        assert got == want, (hash_fun, lane)


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_compress_batch_vs_oracle(hash_fun):
    xs = [tuple(rand_felts(4)) for _ in range(4)]
    ys = [tuple(rand_felts(4)) for _ in range(4)]
    for key in range(4):
        x = jnp.stack([K.pack([d[i] for d in xs]) for i in range(4)])
        y = jnp.stack([K.pack([d[i] for d in ys]) for i in range(4)])
        out = K.compress_batch(hash_fun, key, x, y)
        for b in range(4):
            got = tuple(K.unpack(out[i])[b] for i in range(4))
            assert got == OG.compress(hash_fun, key, xs[b], ys[b])


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_sponge_digest_vs_oracle(hash_fun):
    for n in (1, 7, 8, 9, 16):
        batches = [rand_felts(n) for _ in range(3)]
        dev = jnp.stack([K.pack([b[i] for b in batches]) for i in range(n)])
        out = K.sponge_digest_felts(hash_fun, dev)
        for b in range(3):
            got = tuple(K.unpack(out[i])[b] for i in range(4))
            assert got == OG.digest_felts(hash_fun, batches[b]), (n, b)


# ---------------------------------------------------------------------------
# Oracle pipeline semantics.


def test_bytes_marshalling_sweep():
    # sweeps the 10* byte padding across the 62-byte chunk boundary
    for n in (0, 1, 61, 62, 63, 124):
        data = bytes(range(n % 251)) * (n // 251 + 1)
        felts = OG.bytes_to_felts_gl(data[:n])
        assert len(felts) % 8 == 0
        assert all(0 <= f < (1 << 62) for f in felts)
        # reconstruct the padded byte stream from the felts
        total = b""
        for i in range(0, len(felts), 8):
            v = 0
            for j in range(8):
                v |= felts[i + j] << (62 * j)
            total += v.to_bytes(62, "little")
        assert total[: n] == data[:n]
        assert total[n] == 1  # the 10* marker


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_merkle_digest_tree_shapes(hash_fun):
    comp = OG.compress_fn(hash_fun)
    for n in (1, 2, 3, 5, 8):
        leaves = [tuple(rand_felts(4)) for _ in range(n)]
        t = merkle_tree(leaves, comp)
        assert len(t.layers[0]) == n and len(t.layers[-1]) == 1


@pytest.mark.parametrize("hash_fun", ["poseidon2", "monolith"])
def test_generate_and_check_proof_input(hash_fun):
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=128,
                        block_size=512)
    dset = DataSetConfig(n_slots=3, n_cells=16, n_samples=4)
    pi = generate_proof_input_gl(hash_fun, glob, dset, 1,
                                 OG.int_to_digest(777))
    check_proof_input_gl(hash_fun, glob, pi)
    d = proof_input_gl_to_dict(pi)
    assert len(d["dataSetRoot"]) == 4  # digests export as quads
    assert len(d["merklePaths"]) == 4
    assert all(len(p) == glob.max_depth for p in d["merklePaths"])


def test_check_rejects_tampered_input():
    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=128,
                        block_size=512)
    dset = DataSetConfig(n_slots=3, n_cells=16, n_samples=2)
    pi = generate_proof_input_gl("poseidon2", glob, dset, 0,
                                 OG.int_to_digest(5))
    pi.merkle_paths[0][0] = (1, 2, 3, 4)
    with pytest.raises(AssertionError):
        check_proof_input_gl("poseidon2", glob, pi)


def test_gl_export_singleton_and_odd_paths(tmp_path):
    """Odd-node siblings (int-0 sentinel) must export as zero digests —
    regression: singleton-dataset slot_proof crashed the JSON writer."""
    from codex_storage_proofs_circuits_tpu.oracle.goldilocks_pipeline import (
        export_proof_input_gl,
        generate_proof_input_gl,
    )
    from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource

    glob = GlobalConfig(max_depth=16, max_log2_n_slots=4, cell_size=64,
                        block_size=256)
    for ns, idx in ((1, 0), (5, 4)):
        dset = DataSetConfig(n_slots=ns, n_cells=32, n_samples=2,
                             data_src=DataSource("fake", seed=5))
        pi = generate_proof_input_gl("poseidon2", glob, dset, idx,
                                     OG.int_to_digest(7))
        out = tmp_path / f"gl_{ns}.json"
        export_proof_input_gl(str(out), pi)
        import json

        d = json.loads(out.read_text())
        assert all(isinstance(q, list) and len(q) == 4 for q in d["slotProof"])
