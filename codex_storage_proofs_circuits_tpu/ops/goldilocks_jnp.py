"""Batched Goldilocks arithmetic + hash permutations on 16-bit limb planes.

Batched jnp twin of oracle/goldilocks.py.  A felt batch is a uint32 array of
shape (4, B): little-endian 16-bit limb planes, batch on the lane axis — the
same layout as the BN254 planes (ops/limbs.py), but Goldilocks
needs no Montgomery form: p = 2^64 - 2^32 + 1 gives 2^64 ≡ 2^32 - 1 and
2^96 ≡ -1, so a 128-bit product folds to [0, p) with two cheap 16-bit-plane
folds.  All products are 16x16->32, exact in uint32.

State batches are (12, 4, B).  The hot ops — Poseidon2-GL permutation,
Monolith permutation, keyed digest compression, rate-8 sponge — are pure
jnp (XLA fuses the round chain); they power the Goldilocks device pipeline
the same way ops/poseidon2_jnp.py powers BN254.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..fields import goldilocks as G

NL = 4  # 16-bit limbs per felt
LB = 16
MASK = 0xFFFF
U32 = jnp.uint32

P = G.P_GL
T = G.T
RATE = G.RATE


def _const(x: int, n: int = NL) -> np.ndarray:
    return np.array([(x >> (LB * i)) & MASK for i in range(n)], np.uint32).reshape(n, 1)


P_LIMBS = _const(P)


def pack(values) -> jnp.ndarray:
    values = list(values)
    arr = np.zeros((NL, len(values)), np.uint32)
    for b, v in enumerate(values):
        for i in range(NL):
            arr[i, b] = (v >> (LB * i)) & MASK
    return jnp.asarray(arr)


def unpack(limbs) -> list[int]:
    a = np.asarray(limbs)
    return [int(sum(int(a[i, b]) << (LB * i) for i in range(NL)))
            for b in range(a.shape[1])]


# ---------------------------------------------------------------------------
# Core modular arithmetic on (NL, B) planes.


def _ripple(cols: jnp.ndarray, n_out: int) -> jnp.ndarray:
    """Normalize uint32 columns (values < 2^32) to n_out 16-bit limbs."""
    outs = []
    carry = jnp.zeros_like(cols[0])
    for i in range(n_out):
        c = (cols[i] if i < cols.shape[0] else jnp.zeros_like(carry)) + carry
        outs.append(c & MASK)
        carry = c >> LB
    return jnp.stack(outs)


def _geq_p(a: jnp.ndarray) -> jnp.ndarray:
    """a >= p on 4-limb planes -> bool (1, B)."""
    gt = jnp.zeros(a.shape[1:], bool)
    eq = jnp.ones(a.shape[1:], bool)
    for i in range(NL - 1, -1, -1):
        pi = int(P_LIMBS[i, 0])
        gt = gt | (eq & (a[i] > pi))
        eq = eq & (a[i] == pi)
    return gt | eq


def _cond_sub_p(a: jnp.ndarray) -> jnp.ndarray:
    """a - p where a >= p, else a (a < 2^64 assumed, 4 limbs)."""
    do = _geq_p(a).astype(U32)
    borrow = jnp.zeros_like(a[0])
    outs = []
    for i in range(NL):
        d = a[i] - do * int(P_LIMBS[i, 0]) - borrow
        outs.append(d & MASK)
        borrow = (d >> 31) & 1  # underflow borrows (d is uint32 wraparound)
    return jnp.stack(outs)


def _fold64(limbs5: jnp.ndarray) -> jnp.ndarray:
    """Fold a 5-limb (80-bit) value: v mod 2^64 + hi * (2^32 - 1), hi = v>>64.
    Result is 5 limbs again but with a tiny top; callers fold twice then
    conditionally subtract p."""
    hi = limbs5[4]
    cols = [
        limbs5[0] + (hi * 0xFFFF),          # lo 16 of hi*(2^32-1): hi*0xffff
        limbs5[1] + (hi * 0xFFFF),          # hi*(2^32-1) = hi*0xffff*(1+2^16)
        limbs5[2],
        limbs5[3],
    ]
    return _ripple(jnp.stack(cols), 5)


def _reduce64(limbs5: jnp.ndarray) -> jnp.ndarray:
    """5-limb value < 2^80 -> canonical 4-limb residue.

    Three folds: <2^80 -> <2^64+2^48 -> <2^64+2^32 (top limb may still be 1
    when the low part is near 2^64) -> <2^64; then one conditional subtract.
    """
    v = _fold64(limbs5)
    v = _fold64(v)
    v = _fold64(v)
    return _cond_sub_p(v[:4])


def gl_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    s = _ripple(a + b, 5)
    return _reduce64(s)


def gl_add_const(a: jnp.ndarray, c: int) -> jnp.ndarray:
    return gl_add(a, jnp.asarray(np.broadcast_to(_const(c), (NL, 1))))


def gl_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Full 64x64 -> 128-bit product, folded to [0, p)."""
    # partial products into 8 columns, lo/hi split keeps columns < 2^21
    cols = [jnp.zeros(jnp.broadcast_shapes(a.shape[1:], b.shape[1:]), U32)
            for _ in range(8)]
    for i in range(NL):
        for j in range(NL):
            pij = a[i] * b[j]
            cols[i + j] = cols[i + j] + (pij & MASK)
            cols[i + j + 1] = cols[i + j + 1] + (pij >> LB)
    prod = _ripple(jnp.stack(cols), 8)  # 8 limbs, exact 128-bit product
    # n = A*2^96 + B*2^64 + C  ->  C + B*2^32 + (p - (B + A))  (2^96 ≡ -1)
    C = prod[:4]
    B2 = prod[4:6]  # 2 limbs
    A = prod[6:8]
    # D = B + A < 2^33 (3 limbs); p - D is positive (p ~ 2^64)
    D = _ripple(jnp.stack([B2[0] + A[0], B2[1] + A[1]]), 3)
    borrow = jnp.zeros_like(D[0])
    pmd = []
    for i in range(NL):
        d = int(P_LIMBS[i, 0]) - (D[i] if i < 3 else 0) - borrow
        pmd.append(d & MASK)
        borrow = (d >> 31) & 1
    pmd = jnp.stack(pmd)  # p - D, 4 limbs
    # v = C + (B2 << 32) + pmd  < 3 * 2^64: 5 limbs
    v = _ripple(jnp.stack([
        C[0] + pmd[0],
        C[1] + pmd[1],
        C[2] + pmd[2] + B2[0],
        C[3] + pmd[3] + B2[1],
    ]), 5)
    return _reduce64(v)


def gl_small_mul(a: jnp.ndarray, k: int) -> jnp.ndarray:
    """a * k for small k (< 2^11): per-limb scale then fold."""
    assert 0 <= k < (1 << 11)
    return _reduce64(_ripple(a * np.uint32(k), 5))


# ---------------------------------------------------------------------------
# Poseidon2-GL t=12 permutation over (12, 4, B) states.

_M4 = G.M4


def _m4_vec(x4: list[jnp.ndarray]) -> list[jnp.ndarray]:
    out = []
    for r in range(4):
        cols = None
        for c in range(4):
            term = x4[c] * np.uint32(_M4[r][c])
            cols = term if cols is None else cols + term
        out.append(_reduce64(_ripple(cols, 5)))
    return out


def _external_linear(s: list[jnp.ndarray]) -> list[jnp.ndarray]:
    blocks = [s[i : i + 4] for i in range(0, T, 4)]
    acc = [blocks[0][j] + blocks[1][j] + blocks[2][j] for j in range(4)]
    out: list[jnp.ndarray] = []
    for b in blocks:
        xb = [_ripple(b[j] + acc[j], 5) for j in range(4)]  # < 4p: 5 limbs ok
        xb = [_reduce64(v) for v in xb]
        out += _m4_vec(xb)
    return out


_DIAG_M1 = None  # lazily packed (12, 4, 1) numpy constant planes (numpy, not
# jnp: device arrays created inside a trace leak tracers through the cache)


def _diag_consts():
    global _DIAG_M1
    if _DIAG_M1 is None:
        _DIAG_M1 = [_const((d - 1) % P) for d in G.P2GL_INTERNAL_DIAG]
    return _DIAG_M1


def _internal_linear(s: list[jnp.ndarray]) -> list[jnp.ndarray]:
    diag = _diag_consts()
    tot = s[0]
    for v in s[1:]:
        tot = gl_add(tot, v)
    return [gl_add(tot, gl_mul(s[i], diag[i])) for i in range(T)]


def _sbox7(x: jnp.ndarray) -> jnp.ndarray:
    x2 = gl_mul(x, x)
    x4 = gl_mul(x2, x2)
    return gl_mul(gl_mul(x4, x2), x)


def _rc_planes(vals) -> np.ndarray:
    """List of T ints -> (NL, T, 1) broadcastable limb planes."""
    arr = np.zeros((NL, len(vals), 1), np.uint32)
    for lane, v in enumerate(vals):
        for k in range(NL):
            arr[k, lane, 0] = (v >> (LB * k)) & MASK
    return arr


_P2_EXT_RC = np.stack([_rc_planes(row) for row in G.P2GL_EXTERNAL_RC])  # (RF,NL,T,1)
_P2_INT_RC = np.stack(
    [_rc_planes([c]) for c in G.P2GL_INTERNAL_RC]
)  # (RP, NL, 1, 1)
_P2_DIAG = _rc_planes([(d - 1) % P for d in G.P2GL_INTERNAL_DIAG])  # (NL, T, 1)


def poseidon2_gl_permutation(state: jnp.ndarray) -> jnp.ndarray:
    """(12, 4, B) canonical states -> permuted states.

    Vectorized on whole-state limb planes (ops/gl_core.py) with the rounds
    under lax.scan: the traced graph is 3 round bodies of whole-plane ops —
    both the fastest jnp formulation and ~12x smaller to compile than a
    per-lane version (XLA:CPU compile time is proportional to graph size).
    """
    import jax

    from . import gl_core as C

    b = state.shape[2]
    f4 = [state[:, k, :] for k in range(NL)]
    diag4 = [jnp.asarray(_P2_DIAG[k]) for k in range(NL)]

    def ext_body(carry, rc):
        f4 = C.add(list(carry), [rc[k] for k in range(NL)])
        f4 = C.sbox7_all(f4)
        f4 = C.external_linear(f4)
        return tuple(f4), None

    def int_body(carry, rc):
        f4 = C.add_rc_lane0(list(carry), [rc[k] for k in range(NL)])
        f4 = C.sbox7_lane0(f4)
        f4 = C.internal_linear(f4, diag4)
        return tuple(f4), None

    f4 = tuple(C.external_linear(f4))
    f4, _ = jax.lax.scan(ext_body, f4, jnp.asarray(_P2_EXT_RC[: G.RF // 2]))
    f4, _ = jax.lax.scan(int_body, f4, jnp.asarray(_P2_INT_RC))
    f4, _ = jax.lax.scan(ext_body, f4, jnp.asarray(_P2_EXT_RC[G.RF // 2 :]))
    f4 = C.canon(list(f4))
    return jnp.stack(f4, axis=1)  # (12, NL, B)


# ---------------------------------------------------------------------------
# Monolith permutation over (12, 4, B) states.


def _bar_limb16(x: jnp.ndarray) -> jnp.ndarray:
    """Apply the 8-bit bar to both bytes of a 16-bit limb plane.
    bar(b) = rotl1(b ^ (rotl1(~b) & rotl2(b) & rotl3(b))) per byte."""
    lo = x & 0xFF
    hi = (x >> 8) & 0xFF

    def bar(b):
        rot = lambda v, k: ((v << k) | (v >> (8 - k))) & 0xFF
        y = b ^ (rot(~b & 0xFF, 1) & rot(b, 2) & rot(b, 3))
        return rot(y, 1)

    return bar(lo) | (bar(hi) << 8)


def _bars(s: list[jnp.ndarray]) -> list[jnp.ndarray]:
    out = list(s)
    for i in range(G.MONOLITH_BARS):
        limbs = jnp.stack([_bar_limb16(s[i][j]) for j in range(NL)])
        out[i] = _cond_sub_p(limbs)  # bytewise map keeps value < 2^64
    return out


def _bricks(s: list[jnp.ndarray]) -> list[jnp.ndarray]:
    return [s[0]] + [gl_add(s[i], gl_mul(s[i - 1], s[i - 1])) for i in range(1, T)]


def monolith_permutation(state: jnp.ndarray) -> jnp.ndarray:
    """(12, 4, B) canonical -> permuted; vectorized Bars/Bricks/Concrete
    under lax.scan (structure: oracle/goldilocks.py monolith_permutation)."""
    import jax

    from . import gl_core as C

    rc = jnp.asarray(np.stack([_rc_planes(row) for row in G.MONOLITH_RC]))
    nb = G.MONOLITH_BARS

    def body(carry, rc_r):
        f4 = list(carry)
        # Bars on the first nb lanes: the bytewise map needs canonical
        # inputs and its raw output is only < 2^64 (oracle reduces % P_GL)
        bar_rows = C.canon([f4[k][:nb] for k in range(NL)])
        bar_rows = [_bar_limb16(v) for v in bar_rows]
        bar_rows = C.canon(bar_rows)
        f4 = [
            jnp.concatenate([bar_rows[k], f4[k][nb:]], axis=0) for k in range(NL)
        ]
        # Bricks: out_0 = x_0; out_i = x_i + x_{i-1}^2.  Square every lane,
        # shift the squares down one lane (zero into lane 0), add.
        sq = C.mul(f4, f4)
        zero1 = jnp.zeros_like(f4[0][0:1])
        shifted = [jnp.concatenate([zero1, sq[k][:-1]], axis=0) for k in range(NL)]
        f4 = C.add(f4, shifted)
        # Concrete (Plonky2-compatible circulant) + round constants
        f4 = C.concrete(f4)
        f4 = C.add(f4, [rc_r[k] for k in range(NL)])
        return tuple(f4), None

    f4 = tuple(C.concrete([state[:, k, :] for k in range(NL)]))  # initial Concrete
    f4, _ = jax.lax.scan(body, f4, rc)
    f4 = C.canon(list(f4))
    return jnp.stack(f4, axis=1)


PERMUTATIONS = {
    "poseidon2": poseidon2_gl_permutation,
    "monolith": monolith_permutation,
}


# ---------------------------------------------------------------------------
# Digest ops: batched keyed compression + rate-8 sponge.


def compress_batch(hash_fun: str, key, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """x, y: (4, 4, B) digest batches; key: int or (4, B) plane.
    Returns (4, 4, B) compressed digests."""
    b = x.shape[-1]
    if isinstance(key, int):
        key = jnp.broadcast_to(jnp.asarray(_const(key)), (NL, b)).astype(U32)
    zero = jnp.zeros((NL, b), U32)
    state = jnp.concatenate(
        [x, y, key[None], zero[None], zero[None], zero[None]], axis=0
    )
    out = PERMUTATIONS[hash_fun](state)
    return out[:4]


SPONGE_IV = None


def sponge_digest_felts(hash_fun: str, felts: jnp.ndarray) -> jnp.ndarray:
    """Rate-8 sponge over (n, 4, B) felt batches (10* padding applied here);
    returns (4, 4, B) digests.  Batched twin of oracle digest_felts."""
    global SPONGE_IV
    if SPONGE_IV is None:
        from ..oracle.goldilocks import SPONGE_IV_GL

        SPONGE_IV = _const(SPONGE_IV_GL)  # numpy: safe to cache across traces
    import jax

    from . import gl_core as C

    n, _, b = felts.shape
    perm = PERMUTATIONS[hash_fun]
    total = n + 1
    total += (-total) % RATE
    one = jnp.broadcast_to(jnp.asarray(_const(1)), (1, NL, b)).astype(U32)
    pads = [one]
    if total > n + 1:
        pads.append(jnp.zeros((total - n - 1, NL, b), U32))
    blocks = jnp.concatenate([felts] + pads, axis=0).reshape(
        total // RATE, RATE, NL, b
    )
    iv = jnp.broadcast_to(SPONGE_IV, (NL, b)).astype(U32)
    state = jnp.concatenate([jnp.zeros((T - 1, NL, b), U32), iv[None]], axis=0)

    def body(state, blk):
        # absorb: add the block to the first RATE lanes (loose add via core)
        f4 = [state[:, k, :] for k in range(NL)]
        add4 = [
            jnp.concatenate([blk[:, k, :], jnp.zeros((T - RATE, b), U32)], axis=0)
            for k in range(NL)
        ]
        f4 = C.add(f4, add4)
        return perm(jnp.stack(f4, axis=1)), None

    state, _ = jax.lax.scan(body, state, blocks)
    return state[:4]
