"""Batched Poseidon2 t=3 permutation / compression / sponge on limb planes.

The hot kernel of the whole framework (>95% of all field multiplies, see
SURVEY.md section 3.3).  A batch of states is a uint32 array of shape
(3, NL, B): 3 lanes x 16 limb planes x batch, everything in Montgomery form.

Round schedule matches the reference circuit
(circuit/poseidon2/poseidon2_perm.circom:163-198): initial linear layer,
4 external rounds, 56 internal rounds, 4 external rounds.  The rounds are
driven by lax.scan over stacked round-constant arrays so the traced graph
stays small (3 scan bodies) regardless of batch size.

This is the portable jax.numpy implementation; the CUDA kernels
(ops/cuda/lanes.h) compute the same function one lane per thread.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..fields import bn254
from . import limbs as L

NL = L.NL


def _mont_limbs(x: int) -> np.ndarray:
    return np.array(bn254.to_limbs(bn254.to_mont(x)), dtype=np.uint32).reshape(NL, 1)


# Round constants in Montgomery form.
EXT_RC_MONT = np.stack(
    [np.stack([_mont_limbs(c) for c in triple]) for triple in bn254.EXTERNAL_ROUND_CONSTS]
)  # (8, 3, NL, 1)
INT_RC_MONT = np.stack([_mont_limbs(c) for c in bn254.INTERNAL_ROUND_CONSTS])  # (56, NL, 1)

# Montgomery forms of the Merkle keys 0..3 and of the two sponge IVs.
KEY_MONT = np.stack([_mont_limbs(k) for k in range(4)])  # (4, NL, 1)
SPONGE1_IV_MONT = _mont_limbs((1 << 64) + 0x0301)
SPONGE2_IV_MONT = _mont_limbs((1 << 64) + 0x0302)
ONE_MONT = _mont_limbs(1)


def _sbox(x):
    x2 = L.mont_mul(x, x)
    x4 = L.mont_mul(x2, x2)
    return L.mont_mul(x4, x)


def _linear_layer(state):
    x, y, z = state[0], state[1], state[2]
    s = L.add_mod(L.add_mod(x, y), z)
    return jnp.stack([L.add_mod(x, s), L.add_mod(y, s), L.add_mod(z, s)])


def _external_round(state, rc):
    sx = _sbox(L.add_mod(state[0], rc[0]))
    sy = _sbox(L.add_mod(state[1], rc[1]))
    sz = _sbox(L.add_mod(state[2], rc[2]))
    s = L.add_mod(L.add_mod(sx, sy), sz)
    return jnp.stack([L.add_mod(sx, s), L.add_mod(sy, s), L.add_mod(sz, s)])


def _internal_round(state, c):
    # out = [[2,1,1],[1,2,1],[1,1,3]] @ (sbox(x+c), y, z)
    sx = _sbox(L.add_mod(state[0], c))
    y, z = state[1], state[2]
    u = L.add_mod(L.add_mod(sx, y), z)
    o0 = L.add_mod(u, sx)
    o1 = L.add_mod(u, y)
    o2 = L.add_mod(L.add_mod(u, z), z)
    return jnp.stack([o0, o1, o2])


def permutation(state: jnp.ndarray) -> jnp.ndarray:
    """Full 64-round permutation on a (3, NL, B) Montgomery-form batch."""
    state = _linear_layer(state)

    def ext_body(st, rc):
        return _external_round(st, rc), None

    def int_body(st, c):
        return _internal_round(st, c), None

    state, _ = jax.lax.scan(ext_body, state, jnp.asarray(EXT_RC_MONT[:4]))
    state, _ = jax.lax.scan(int_body, state, jnp.asarray(INT_RC_MONT))
    state, _ = jax.lax.scan(ext_body, state, jnp.asarray(EXT_RC_MONT[4:]))
    return state


def compress(x: jnp.ndarray, y: jnp.ndarray, key_mont: jnp.ndarray) -> jnp.ndarray:
    """Batched keyed 2-to-1 compression: first lane of permutation(x, y, key).

    x, y: (NL, B); key_mont: (NL, 1) or (NL, B) Montgomery-form key.
    """
    b = x.shape[1]
    key = jnp.broadcast_to(key_mont, (NL, b)).astype(jnp.uint32)
    state = jnp.stack([x, y, key])
    return permutation(state)[0]


def sponge2_absorb(blocks: jnp.ndarray) -> jnp.ndarray:
    """Rate-2 sponge over pre-padded blocks.

    blocks: (nblocks, 2, NL, B) Montgomery-form field elements, already
    including the felt-level `10*` padding.  Returns the squeezed first lane
    (NL, B) in Montgomery form.
    """
    nb, two, nl, b = blocks.shape
    assert two == 2 and nl == NL
    iv = jnp.broadcast_to(jnp.asarray(SPONGE2_IV_MONT), (NL, b)).astype(jnp.uint32)
    zero = jnp.zeros((NL, b), jnp.uint32)
    state = jnp.stack([zero, zero, iv])

    def body(st, blk):
        st = st.at[0].set(L.add_mod(st[0], blk[0]))
        st = st.at[1].set(L.add_mod(st[1], blk[1]))
        return permutation(st), None

    state, _ = jax.lax.scan(body, state, blocks)
    return state[0]


def pad_felts_rate2(felts: jnp.ndarray) -> jnp.ndarray:
    """(nfelts, NL, B) Montgomery felts -> (nblocks, 2, NL, B) padded blocks.

    Appends the Montgomery form of 1 (and a 0 filler when needed) per the
    felt-level `10*` padding (poseidon2_sponge.circom:43-50).
    """
    nfelts, nl, b = felts.shape
    one = jnp.broadcast_to(jnp.asarray(ONE_MONT), (1, NL, b)).astype(jnp.uint32)
    padded = jnp.concatenate([felts, one], axis=0)
    if padded.shape[0] % 2 == 1:
        padded = jnp.concatenate([padded, jnp.zeros((1, NL, b), jnp.uint32)], axis=0)
    return padded.reshape(-1, 2, NL, b)


def sponge2_hash(felts: jnp.ndarray) -> jnp.ndarray:
    """Batched sponge2 of (nfelts, NL, B) Montgomery felts -> (NL, B)."""
    return sponge2_absorb(pad_felts_rate2(felts))
