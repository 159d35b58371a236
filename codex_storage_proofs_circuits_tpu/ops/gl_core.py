"""Vectorized Goldilocks field + Poseidon2-GL round primitives on limb
planes, the building blocks of the portable jnp path (ops/goldilocks_jnp.py).

A felt batch is `f4 = [L0, L1, L2, L3]`: four (R, B) uint32 planes of
little-endian 16-bit limbs, R = number of independent lanes (12 for a full
state).  Invariant between ops ("loose"): limbs < 2^16, value < 2^64 (not
necessarily < p); `canon` makes values canonical (< p) with one conditional
subtract.  All products are 16x16->32, exact in uint32; the 128-bit product
folds to a loose value via 2^64 ≡ 2^32 - 1, 2^96 ≡ -1.

Keeping every op a whole-plane elementwise u32 instruction (no per-lane
Python lists, no broadcasts in the product) is what makes this both
fast and ~12x smaller as a traced jaxpr than
a per-lane formulation — the latter matters because XLA:CPU compile time
is proportional to graph size (observed minutes vs seconds on small hosts).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..fields import goldilocks as G

T = G.T  # 12 lanes per state
NL = 4  # 16-bit limbs per felt
LB = 16
MASK = 0xFFFF
U32 = jnp.uint32
P = G.P_GL

P_LIMB = [(P >> (LB * k)) & MASK for k in range(NL)]  # (1, 0, 0xffff, 0xffff)


def ripple(cols, n_out):
    """List of column planes (< 2^32 each) -> (n_out canonical limb planes,
    carry plane)."""
    outs = []
    carry = None
    for k in range(n_out):
        c = cols[k] if k < len(cols) else None
        if c is None and carry is None:
            outs.append(None)
            continue
        v = c if carry is None else (c + carry if c is not None else carry)
        outs.append(v & MASK)
        carry = v >> LB
    zero = jnp.zeros_like(next(o for o in outs if o is not None))
    outs = [zero if o is None else o for o in outs]
    return outs, (carry if carry is not None else zero)


def fold_carry(f4, c):
    """f4 + c * 2^64 (c small) -> loose f4 (2^64 ≡ 2^32 - 1)."""
    e = c * U32(MASK)
    outs, c2 = ripple([f4[0] + e, f4[1] + e, f4[2], f4[3]], NL)
    # first fold leaves value < 2^64 + c*2^33; the second terminates
    e2 = c2 * U32(MASK)
    outs, _ = ripple([outs[0] + e2, outs[1] + e2, outs[2], outs[3]], NL)
    return outs


def add(a4, b4):
    """Loose + loose -> loose."""
    outs, c = ripple([a4[k] + b4[k] for k in range(NL)], NL)
    return fold_carry(outs, c)


def mul(a4, b4):
    """Loose x loose -> loose.  Schoolbook 16 products + 2^64/2^96 folds."""
    cols = [None] * 8
    for i in range(NL):
        for j in range(NL):
            t = a4[i] * b4[j]
            tl = t & MASK
            th = t >> LB
            cols[i + j] = tl if cols[i + j] is None else cols[i + j] + tl
            cols[i + j + 1] = (
                th if cols[i + j + 1] is None else cols[i + j + 1] + th
            )
    limbs, _ = ripple(cols, 8)  # exact 128-bit product, carry-out 0
    # n = A*2^96 + B*2^64 + C  ≡  C + B*2^32 + (p - (B + A))   (mod p)
    B0, B1 = limbs[4], limbs[5]
    A0, A1 = limbs[6], limbs[7]
    d, _ = ripple([B0 + A0, B1 + A1], 3)  # D = B + A < 2^33
    pmd = []
    borrow = None
    for k in range(NL):
        dk = d[k] if k < 3 else None
        t = U32(P_LIMB[k] + 0x10000)
        if dk is not None:
            t = t - dk
        if borrow is not None:
            t = t - borrow
        pmd.append(t & MASK)
        borrow = (t >> LB) ^ U32(1)  # 1 iff borrowed
    v, c = ripple(
        [
            limbs[0] + pmd[0],
            limbs[1] + pmd[1],
            limbs[2] + pmd[2] + B0,
            limbs[3] + pmd[3] + B1,
        ],
        NL,
    )  # value < 3 * 2^64 -> carry c <= 2
    return fold_carry(v, c)


def canon(f4):
    """Loose (< 2^64) -> canonical (< p): one conditional subtract."""
    gt = None
    eq = None
    for k in range(NL - 1, -1, -1):
        pk = U32(P_LIMB[k])
        g = (f4[k] > pk).astype(U32)
        e = (f4[k] == pk).astype(U32)
        if gt is None:
            gt, eq = g, e
        else:
            gt = gt | (eq & g)
            eq = eq & e
    do = gt | eq  # 1 iff f4 >= p
    outs = []
    borrow = None
    for k in range(NL):
        t = f4[k] + U32(0x10000) - do * U32(P_LIMB[k])
        if borrow is not None:
            t = t - borrow
        outs.append(t & MASK)
        borrow = (t >> LB) ^ U32(1)
    return outs


# ---------------------------------------------------------------------------
# Poseidon2-GL round pieces on full 12-lane states (planes (12, B)).


def sbox7_all(f4):
    """x^7 on every lane."""
    x2 = mul(f4, f4)
    x4 = mul(x2, x2)
    x6 = mul(x4, x2)
    return mul(x6, f4)


def _m4_chain(x, mul2, mul4):
    x0, x1, x2, x3 = x
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = mul2(x1) + t1
    t3 = mul2(x3) + t0
    t4 = mul4(t1) + t3
    t5 = mul4(t0) + t2
    t6 = t3 + t5
    t7 = t2 + t4
    return t6, t5, t7, t4


def external_linear(f4):
    """circ(2*M4, M4, M4) on loose 12-lane states -> loose."""
    mul2 = lambda v: v + v
    mul4 = lambda v: (v + v) + (v + v)
    out_cols = [None] * NL
    for k in range(NL):
        x = f4[k]  # (12, B)
        b = [x[4 * blk : 4 * blk + 4] for blk in range(3)]
        s = b[0] + b[1] + b[2]
        rows = []
        for blk in range(3):
            xb = b[blk] + s  # columns < 4 * 2^16
            pos = [xb[j : j + 1] for j in range(4)]
            rows.extend(_m4_chain(pos, mul2, mul4))  # columns < 2^22
        out_cols[k] = jnp.concatenate(rows, axis=0)
    limbs, c = ripple(out_cols, NL)
    return fold_carry(limbs, c)


MONO_CIRC = G.MONOLITH_CONCRETE_CIRC
MONO_DIAG0 = G.MONOLITH_CONCRETE_DIAG[0]  # +8 on row 0 only


def concrete(f4):
    """Monolith Concrete layer: the Plonky2-compatible MDS circulant
    (fields/goldilocks.py MONOLITH_CONCRETE) on loose 12-lane states.
    out[r] = sum_j CIRC[j] * x[(r+j) mod 12], plus DIAG[0]*x[0] on row 0.
    sum(CIRC) + DIAG[0] = 264, so columns stay < 2^25 before the ripple."""
    out_cols = [None] * NL
    for k in range(NL):
        x = f4[k]  # (12, B)
        acc = None
        for j in range(T):
            rolled = x if j == 0 else jnp.concatenate([x[j:], x[:j]], axis=0)
            term = rolled * U32(MONO_CIRC[j])
            acc = term if acc is None else acc + term
        d0 = x[0:1] * U32(MONO_DIAG0)
        acc = jnp.concatenate([acc[0:1] + d0, acc[1:]], axis=0)
        out_cols[k] = acc
    limbs, c = ripple(out_cols, NL)
    return fold_carry(limbs, c)


def lane_sum(x):
    """Sum the 12 lane rows -> (1, B) (manual slice tree)."""
    s = x[0:6] + x[6:12]
    s = s[0:3] + s[3:6]
    return s[0:1] + s[1:2] + s[2:3]


def internal_linear(f4, diag4):
    """J + diag(mu - 1): out = sum(lanes) + (mu - 1) * x, loose -> loose.

    diag4: the (mu - 1) constants as 4 broadcastable (12, 1)/(12, B) planes.
    """
    tot_cols = [lane_sum(f4[k]) for k in range(NL)]
    tot, c = ripple(tot_cols, NL)  # columns < 12 * 2^16 < 2^20
    tot = fold_carry(tot, c)
    scaled = mul(f4, diag4)
    bt = f4[0].shape[-1]
    tot_b = [jnp.broadcast_to(tot[k], (T, bt)) for k in range(NL)]
    return add(tot_b, scaled)


def add_rc_lane0(f4, rc4):
    """Add a lane-0-only constant (rc4 planes shaped (1, B) or (1, 1))."""
    row = [f4[k][0:1] for k in range(NL)]
    out0 = add(row, [jnp.broadcast_to(rc4[k], row[k].shape) for k in range(NL)])
    return [jnp.concatenate([out0[k], f4[k][1:]], axis=0) for k in range(NL)]


def sbox7_lane0(f4):
    row = [f4[k][0:1] for k in range(NL)]
    out0 = sbox7_all(row)
    return [jnp.concatenate([out0[k], f4[k][1:]], axis=0) for k in range(NL)]
