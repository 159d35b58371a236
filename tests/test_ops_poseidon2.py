"""Batched Poseidon2 (jnp path) vs the scalar oracle.

Small canonical batch (B=16) to bound the one-time XLA compile; the CUDA
kernel is checked against this path in tests/test_kernels.py.
"""

import random

import jax
import jax.numpy as jnp
import pytest

from codex_storage_proofs_circuits_tpu.fields import bn254 as F
from codex_storage_proofs_circuits_tpu.ops import limbs as L, poseidon2_jnp as P2
from codex_storage_proofs_circuits_tpu.oracle import poseidon2 as OP

B = 16


@pytest.fixture(scope="module")
def batch():
    random.seed(7)
    triples = [
        (0, 1, 2),
        (0, 0, 0),
        (F.P - 1, F.P - 1, F.P - 1),
    ] + [
        (random.randrange(F.P), random.randrange(F.P), random.randrange(F.P))
        for _ in range(B - 3)
    ]
    state = jnp.stack(
        [L.pack([F.to_mont(t[i]) for t in triples]) for i in range(3)]
    )
    return triples, state


def test_permutation_batch_vs_oracle(batch):
    triples, state = batch
    out = jax.jit(P2.permutation)(state)
    outs = [L.unpack(out[i]) for i in range(3)]
    for j, t in enumerate(triples):
        got = tuple(F.from_mont(outs[i][j]) for i in range(3))
        assert got == OP.permutation(t), f"batch col {j}"


def test_compress_batch_vs_oracle(batch):
    random.seed(8)
    xs = [random.randrange(F.P) for _ in range(B)]
    ys = [random.randrange(F.P) for _ in range(B)]
    xm, ym = L.pack([F.to_mont(v) for v in xs]), L.pack([F.to_mont(v) for v in ys])
    for key in (0, 3):
        c = jax.jit(P2.compress)(xm, ym, jnp.asarray(P2.KEY_MONT[key]))
        got = [F.from_mont(v) for v in L.unpack(c)]
        assert got == [OP.keyed_compression(key, a, b) for a, b in zip(xs, ys)]


def test_sponge2_hash_vs_oracle(batch):
    # hash 5 felts per batch column (odd count exercises the 1,0 padding)
    random.seed(9)
    cols = [[random.randrange(F.P) for _ in range(5)] for _ in range(B)]
    felts = jnp.stack(
        [L.pack([F.to_mont(col[k]) for col in cols]) for k in range(5)]
    )  # (5, NL, B)
    h = jax.jit(P2.sponge2_hash)(felts)
    got = [F.from_mont(v) for v in L.unpack(h)]
    assert got == [OP.sponge2(col) for col in cols]
