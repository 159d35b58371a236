"""BN254 Fr arithmetic on 16-bit limb planes (uint32), batched in jnp.

The reference outsources Fr arithmetic to native libraries
(constantine / zikkurat-algebra, see SURVEY.md section 2b); here a
field-element batch is a uint32 array of shape (16, B) — little-endian
16-bit limb planes with batch on the minor (lane) axis, which every plain
jnp op vectorizes across.  All products are 16x16->32 bit, exact in uint32;
column sums stay below 2^22, so 64-bit arithmetic is never needed.

Montgomery form with radix R = 2^256; mont_mul = SOS multiply + full-width
REDC.  Carry/borrow chains are resolved with Kogge-Stone parallel-prefix
(log2(#limbs) steps of whole-plane shifts) instead of sequential ripples, so
every op is a short chain of dense (NL, B) vector instructions.  The CUDA
kernels (ops/cuda/lanes.h) take and return this layout but compute on
64-bit limbs.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..fields import bn254

NL = bn254.NUM_LIMBS  # 16
LB = bn254.LIMB_BITS  # 16
MASK = bn254.LIMB_MASK  # 0xffff

U32 = jnp.uint32


def _const_limbs(x: int, n: int = NL) -> np.ndarray:
    """Integer -> (n, 1) uint32 limb-plane column (broadcastable constant)."""
    limbs = [(x >> (LB * i)) & MASK for i in range(n)]
    return np.array(limbs, dtype=np.uint32).reshape(n, 1)


P_LIMBS = _const_limbs(bn254.P)
PINV_LIMBS = _const_limbs(bn254.P_INV_NEG_FULL)  # -P^-1 mod 2^256
R2_LIMBS = _const_limbs(bn254.R2_MONT)
ONE_LIMBS = _const_limbs(1)
R_LIMBS = _const_limbs(bn254.R_MONT)  # Montgomery form of 1


# ---------------------------------------------------------------------------
# Host-side packing helpers


def pack(values) -> jnp.ndarray:
    """Iterable of python ints -> (NL, B) uint32 limb planes."""
    values = list(values)
    arr = np.zeros((NL, len(values)), dtype=np.uint32)
    for b, v in enumerate(values):
        for i in range(NL):
            arr[i, b] = (v >> (LB * i)) & MASK
    return jnp.asarray(arr)


def unpack(limbs) -> list[int]:
    """(NL, B) uint32 limb planes -> list of python ints."""
    import jax

    arr = jax.device_get(limbs) if not isinstance(limbs, np.ndarray) else limbs
    out = []
    for b in range(arr.shape[1]):
        acc = 0
        for i in range(arr.shape[0]):
            acc |= int(arr[i, b]) << (LB * i)
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# Carry / borrow resolution (Kogge-Stone parallel prefix over the limb axis)


def _shift_up(x: jnp.ndarray, d: int) -> jnp.ndarray:
    """out[i] = x[i-d] (zeros shifted in at the bottom), along axis 0."""
    pad = jnp.zeros((d,) + x.shape[1:], x.dtype)
    return jnp.concatenate([pad, x[:-d]], axis=0)


def _ks_carry_in(gen: jnp.ndarray, prop: jnp.ndarray) -> jnp.ndarray:
    """carry_in[i] = gen[i-1] | (prop[i-1] & gen[i-2]) | ... resolved in
    log2(K) doubling steps.  gen/prop are 0/1 uint32 planes."""
    k = gen.shape[0]
    d = 1
    while d < k:
        gen = gen | (prop & _shift_up(gen, d))
        prop = prop & _shift_up(prop, d)
        d *= 2
    return _shift_up(gen, 1)


def normalize(cols: jnp.ndarray, max_col_bits: int = 22) -> jnp.ndarray:
    """Carry-saved columns (K, B) (each < 2^max_col_bits) -> canonical 16-bit
    limbs, mod 2^(16K) (any carry out of the top limb is dropped — all call
    sites guarantee the value fits the container)."""
    x = cols
    bits = max_col_bits
    # fixed passes until limbs are <= 0x10000
    while bits > 17:
        x = (x & MASK) + _shift_up(x >> LB, 1)
        bits = max(17, bits - LB + 1)
    x = (x & MASK) + _shift_up(x >> LB, 1)  # now limbs <= 0x10000
    low = x & MASK
    gen = x >> LB  # 1 iff limb == 0x10000
    prop = (low == MASK).astype(U32)
    carry_in = _ks_carry_in(gen, prop)
    return (low + carry_in) & MASK


def _sub_with_borrow(a: jnp.ndarray, b) -> tuple[jnp.ndarray, jnp.ndarray]:
    """a - b on canonical limb planes; returns (diff mod 2^(16K), borrow_out
    (B,) in {0,1})."""
    t = a + U32(0x10000) - b  # in [1, 0x1ffff]
    gen = (t >> LB) ^ U32(1)  # 1 iff a_i < b_i
    prop = (t == 0x10000).astype(U32)  # equality: borrow propagates
    k = a.shape[0]
    d = 1
    while d < k:
        gen = gen | (prop & _shift_up(gen, d))
        prop = prop & _shift_up(prop, d)
        d *= 2
    borrow_in = _shift_up(gen, 1)
    diff = (t - borrow_in) & MASK
    # final borrow-out = resolved generate at the top limb; static slice
    # (negative indexing lowers to dynamic_slice, which Mosaic cannot lower)
    return diff, gen[k - 1 : k][0]


def _cond_sub_p(x: jnp.ndarray, p=None) -> jnp.ndarray:
    """Reduce a canonical-limb value < 2P modulo P (one conditional subtract)."""
    if p is None:
        p = jnp.asarray(P_LIMBS)
    diff, borrow = _sub_with_borrow(x, p)
    return jnp.where(borrow == 0, diff, x)


# ---------------------------------------------------------------------------
# Public modular ops (canonical Montgomery-form in, same out)


def add_mod(a: jnp.ndarray, b: jnp.ndarray, p=None) -> jnp.ndarray:
    """(a + b) mod P on (NL, B) limb planes."""
    s = a + b  # columns <= 2^17 - 2; a+b < 2P < 2^255 fits 16 limbs
    return _cond_sub_p(normalize(s, max_col_bits=17), p)


def sub_mod(a: jnp.ndarray, b: jnp.ndarray, p=None) -> jnp.ndarray:
    """(a - b) mod P on (NL, B) limb planes."""
    if p is None:
        p = jnp.asarray(P_LIMBS)
    diff, borrow = _sub_with_borrow(a, b)
    plus_p = normalize(diff + p, max_col_bits=17)
    return jnp.where(borrow == 0, diff, plus_p)


def mont_mul(
    a: jnp.ndarray, b: jnp.ndarray, p=None, pinv_unused=None, unroll: bool = False
) -> jnp.ndarray:
    """Montgomery product a*b*R^-1 mod P on (NL, B) limb planes.

    CIOS (coarsely integrated operand scanning) with carry-save columns:
    one pass over b's limbs, interleaving a*b_j accumulation with per-limb
    Montgomery reduction.  The accumulator never exceeds NL+1 columns of
    < 2^22, so everything stays in uint32 vector ops with a single final
    carry resolution — ~8x fewer ops than a separate SOS multiply + REDC.

    Inputs canonical (< P); output canonical.

    unroll=False drives the limb pass with lax.fori_loop (16x smaller traced
    graph — XLA:CPU compile of the unrolled body is pathologically slow);
    unroll=True emits the straight-line body.
    """
    if p is None:
        p = jnp.asarray(P_LIMBS)
    tail = a.shape[1:]
    if b.shape[1:] != tail:
        # constant operand (NL, 1): widen on lanes
        b = jnp.broadcast_to(b, (NL,) + tail)
    if p.shape[1:] != tail:
        p = jnp.broadcast_to(p, (NL,) + tail)
    # BN254 Fr has P == 1 (mod 2^16), so -P^-1 == -1 (mod 2^16) and the
    # per-limb Montgomery quotient is just a negation — no multiply.
    assert bn254.P_INV_NEG_16 == MASK
    zero1 = jnp.zeros((1,) + tail, U32)
    zero_top = jnp.zeros((NL - 1,) + tail, U32)

    def step(acc, bj):
        # The accumulator stays NL columns, not NL+1:
        # the high halves of the two products belong to column i+1, which is
        # column i after the down-shift — add them post-shift instead of
        # materializing an NL+1-row carry plane.
        t = a * bj[None]  # (NL, B) 16x16->32 exact
        tl = t & MASK
        mj = (U32(0) - (acc[0:1] + tl[0:1])) & MASK  # -column0 mod 2^16
        q = p * mj  # (NL, B)
        s = acc + tl + (q & MASK)  # columns < 2^22 + 2^17: no overflow
        carry = s[0:1] >> LB  # column 0 is 0 mod 2^16 by choice of mj
        hi = (t >> LB) + (q >> LB)
        return (
            jnp.concatenate([s[1:], zero1], axis=0)
            + hi
            + jnp.concatenate([carry, zero_top], axis=0)
        )

    acc = jnp.zeros((NL,) + tail, U32)
    if unroll:
        for j in range(NL):
            acc = step(acc, b[j])
    else:
        import jax

        acc, _ = jax.lax.scan(lambda c, bj: (step(c, bj), None), acc, b)
    # value < 2P (columns <= 16*2^18 + carries, i.e. < 2^23): resolve
    # carries, reduce mod P
    res = normalize(acc, max_col_bits=23)
    return _cond_sub_p(res, p)


def mont_sqr(a: jnp.ndarray) -> jnp.ndarray:
    return mont_mul(a, a)


def to_mont(a: jnp.ndarray) -> jnp.ndarray:
    """Canonical standard form -> Montgomery form."""
    return mont_mul(a, jnp.broadcast_to(jnp.asarray(R2_LIMBS), a.shape))


def from_mont(a: jnp.ndarray) -> jnp.ndarray:
    """Montgomery form -> canonical standard form."""
    return mont_mul(a, jnp.broadcast_to(jnp.asarray(ONE_LIMBS), a.shape))
