"""Device-side fake-data PRNG: bit-exact uint64 recurrence on limb planes.

The reference mock backend (reference/nim/proof_input/src/slot.nim:22-32,
== Slot.hs:87-96) steps, per byte, a uint64 state with deliberate wraparound
and a final `mod 1698428844001831`.  Sequential along the byte axis,
independent across cells — so it runs with the whole cell batch on lanes,
emitting one byte row per step: as a lax.scan (the plain path) or as a
Pallas-Triton kernel with one cell per GPU thread (ops/routes.py picks).
Data generation stays on the device: no host PRNG, no host->device transfer
of cell bytes.

uint64 values are (4, B) uint32 planes of 16-bit limbs (little-endian).
All products are 16x16->32, exact in uint32; the modulo is Barrett with a
14-bit approximate quotient.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..oracle.slot import FAKE_MODULUS

U32 = jnp.uint32
MASK = 0xFFFF
NL = 4

_M = FAKE_MODULUS  # 1698428844001831 < 2^51
_MU = (1 << 101) // _M  # Barrett reciprocal, < 2^51
_M_LIMBS = [(_M >> (16 * i)) & MASK for i in range(4)]
_MU_LIMBS = [(_MU >> (16 * i)) & MASK for i in range(4)]


def _const_planes(x: int, n: int = NL) -> np.ndarray:
    return np.array([(x >> (16 * i)) & MASK for i in range(n)], np.uint32).reshape(
        n, 1
    )


def _ripple(cols, n_out: int):
    outs = []
    carry = jnp.zeros_like(cols[0])
    for i in range(n_out):
        c = (cols[i] if i < len(cols) else carry * 0) + carry
        outs.append(c & MASK)
        carry = c >> 16
    return outs


def _add64(a, b):
    """(a + b) mod 2^64 on 4-limb lists."""
    return _ripple([a[i] + b[i] for i in range(4)], 4)


def _xor64(a, b):
    return [a[i] ^ b[i] for i in range(4)]


def _mul64(a, b):
    """(a * b) mod 2^64: lower 4 limb columns of the product."""
    cols = [None] * 4
    for i in range(4):
        for j in range(4 - i):
            p = a[i] * b[j]
            k = i + j
            cols[k] = p & MASK if cols[k] is None else cols[k] + (p & MASK)
            if k + 1 < 4:
                hi = p >> 16
                cols[k + 1] = hi if cols[k + 1] is None else cols[k + 1] + hi
    return _ripple(cols, 4)


def _mul_wide(a, b, na: int, nb: int, n_out: int):
    """Full product of na-limb x nb-limb values, n_out limb columns."""
    cols = [jnp.zeros_like(a[0]) for _ in range(n_out)]
    for i in range(na):
        for j in range(nb):
            if i + j >= n_out:
                continue
            p = a[i] * b[j]
            cols[i + j] = cols[i + j] + (p & MASK)
            if i + j + 1 < n_out:
                cols[i + j + 1] = cols[i + j + 1] + (p >> 16)
    return _ripple(cols, n_out)


def _mod_m(v):
    """v (4 limbs, < 2^64) mod _M via Barrett: q = ((v >> 50) * MU) >> 51,
    q <= floor(v/M) <= q + 2, so two conditional subtracts finish.

    q itself is a SINGLE 16-bit limb: floor(v/M) < 2^64 / 2^50.59 < 2^13.5,
    so q*M is a 1x4 product (4 multiplies), not the 4x4 the first version
    paid (~17% of the whole PRNG step)."""
    top = (v[3] >> 2) & 0x3FFF  # v >> 50 (14 bits: limb 3 bits 2..15)
    mu = [jnp.full_like(v[0], l) for l in _MU_LIMBS]
    prod = _mul_wide([top], mu, 1, 4, 5)  # top * MU, < 2^65
    # >> 51 = drop 3 limbs then >> 3; bits 51..64 live in limbs 3..4
    q = ((prod[3] >> 3) | (prod[4] << 13)) & MASK  # one limb, < 2^14
    m = [jnp.full_like(v[0], l) for l in _M_LIMBS]
    qm = _mul_wide([q], m, 1, 4, 5)  # q*M <= v < 2^64 (+ slack limb)
    # r = v - q*M, in [0, 3M): borrow-ripple subtract then 2 cond-subs
    r = []
    borrow = jnp.zeros_like(v[0])
    for i in range(4):
        d = v[i] - qm[i] - borrow
        r.append(d & MASK)
        borrow = (d >> 31) & 1
    for _ in range(2):
        r = _cond_sub_m(r)
    return r


def _cond_sub_m(a):
    """a - M where a >= M else a (a < 2^64)."""
    gt = jnp.zeros(a[0].shape, bool)
    eq = jnp.ones(a[0].shape, bool)
    for i in range(3, -1, -1):
        gt = gt | (eq & (a[i] > _M_LIMBS[i]))
        eq = eq & (a[i] == _M_LIMBS[i])
    do = (gt | eq).astype(U32)
    out = []
    borrow = jnp.zeros_like(a[0])
    for i in range(4):
        d = a[i] - do * _M_LIMBS[i] - borrow
        out.append(d & MASK)
        borrow = (d >> 31) & 1
    return out


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _gen_scan(seed1_planes, seed2_planes, n_steps: int):
    """seed planes (4, B); returns (n_steps, B) uint8 byte rows.

    The byte recurrence is strictly sequential per cell, so it runs as a
    scan over byte steps with the cell batch on lanes."""
    s1 = [seed1_planes[i] for i in range(4)]
    s2 = [seed2_planes[i] for i in range(4)]
    xor_c = [jnp.full_like(s1[0], l) for l in [0x5A5A, 0x5A5A, 0, 0]]
    c17 = [jnp.full_like(s1[0], l) for l in [17, 0, 0, 0]]
    one = [jnp.full_like(s1[0], l) for l in [1, 0, 0, 0]]
    s2p17 = _add64(s2, c17)

    def body(state, _):
        s = _prng_step([state[i] for i in range(4)], s1, s2, xor_c, s2p17)
        return jnp.stack(s), (s[0] & 0xFF).astype(jnp.uint8)

    _, bytes_rows = jax.lax.scan(body, jnp.stack(one), None, length=n_steps)
    return bytes_rows  # (n_steps, B) uint8


def fake_seed_planes(seed: int, start_idx: int, n: int):
    """Host-side derivation of the per-cell seed limb planes: (s1, s2),
    each (4, n) uint32, matching oracle slot.gen_fake_cell's seed1/seed2."""
    seed1 = (seed + 0xDEADCAFE) & 0xFFFFFFFFFFFFFFFF
    idx = np.arange(start_idx, start_idx + n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        seed2 = idx + np.uint64(0x98765432)
    s1 = jnp.asarray(np.broadcast_to(_const_planes(seed1), (4, n)).copy())
    s2p = np.zeros((4, n), np.uint32)
    for i in range(4):
        s2p[i] = ((seed2 >> np.uint64(16 * i)) & np.uint64(MASK)).astype(np.uint32)
    return s1, jnp.asarray(s2p)


# ---------------------------------------------------------------------------
# Pallas-Triton kernel for the byte recurrence.  The plain scan above runs
# as a cell_size-trip while loop over tiny (4, B) bodies, so per-trip launch
# overhead sets its pace.  Here each GPU thread owns one cell: its state
# stays in registers for the whole chain, and every four bytes leave as one
# packed u32 row store.

_BT = 128  # lanes per program: one lane per thread at 4 warps


def _prng_step(s, s1l, s2l, xor_c, s2p17):
    """One recurrence step on limb rows; shared by the scan and the kernel.

    s(s+s1)(s+s2) + s(s^C) + s1*s + s2 + 17
      == s * [(s+s1)(s+s2) + (s^C) + s1] + s2 + 17   (mod 2^64), then mod M.
    """
    inner = _mul64(_add64(s, s1l), _add64(s, s2l))
    inner = _add64(inner, _xor64(s, xor_c))
    inner = _add64(inner, s1l)
    return _mod_m(_add64(_mul64(s, inner), s2p17))


def _prng_kernel(s1_ref, s2_ref, out_ref):
    # s1_ref, s2_ref: (4, BT) limb rows; out_ref: (n_words, BT) packed bytes
    n_words = out_ref.shape[0]
    s1l = [s1_ref[i, :] for i in range(4)]
    s2l = [s2_ref[i, :] for i in range(4)]
    zero = jnp.zeros_like(s1l[0])
    xor_c = [zero + 0x5A5A, zero + 0x5A5A, zero, zero]
    s2p17 = _add64(s2l, [zero + 17, zero, zero, zero])

    def body(w, state):
        s = list(state)
        packed = zero
        for j in range(4):
            s = _prng_step(s, s1l, s2l, xor_c, s2p17)
            packed = packed | ((s[0] & 0xFF) << (8 * j))
        out_ref[w, :] = packed
        return tuple(s)

    jax.lax.fori_loop(0, n_words, body, (zero + 1, zero, zero, zero))


@functools.partial(jax.jit, static_argnames=("n_steps", "interpret"))
def _gen_triton(seed1_planes, seed2_planes, n_steps: int, interpret: bool = False):
    """(n_steps, B) uint8 byte rows via the Triton kernel; bit-exact to
    _gen_scan.  Lanes pad to a multiple of _BT and steps to four times a
    power of two (Triton block shapes); the padding is sliced off, and extra
    trailing steps never change the earlier bytes of a cell."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    B = seed1_planes.shape[1]
    n_words = 1 << max(0, (-(-n_steps // 4) - 1).bit_length())
    pad = (-B) % _BT
    s1 = jnp.pad(seed1_planes, ((0, 0), (0, pad)))
    s2 = jnp.pad(seed2_planes, ((0, 0), (0, pad)))
    Bp = B + pad
    packed = pl.pallas_call(
        _prng_kernel,
        grid=(Bp // _BT,),
        in_specs=[pl.BlockSpec((4, _BT), lambda g: (0, g))] * 2,
        out_specs=pl.BlockSpec((n_words, _BT), lambda g: (0, g)),
        out_shape=jax.ShapeDtypeStruct((n_words, Bp), U32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fake_prng",
    )(s1, s2)
    rows = jnp.stack([(packed >> (8 * j)) & 0xFF for j in range(4)], axis=1)
    return rows.reshape(4 * n_words, Bp)[:n_steps, :B].astype(jnp.uint8)


def gen_rows(seed1_planes, seed2_planes, n_steps: int):
    """Byte rows (n_steps, B) by the route ops.routes picks for "prng"."""
    from . import routes

    if routes.route("prng") == "triton":
        return _gen_triton(
            seed1_planes, seed2_planes, n_steps, interpret=not routes.on_gpu()
        )
    return _gen_scan(seed1_planes, seed2_planes, n_steps)


def fake_seed_bases(seed: int, start_idx: int):
    """Tiny (4,) uint32 limb vectors (seed1, seed2 base) for device-side
    seed-plane construction — 32 bytes of upload per chunk instead of the
    two (4, B) plane arrays."""
    seed1 = (seed + 0xDEADCAFE) & 0xFFFFFFFFFFFFFFFF
    base2 = (start_idx + 0x98765432) & 0xFFFFFFFFFFFFFFFF
    to4 = lambda v: np.array([(v >> (16 * i)) & MASK for i in range(4)], np.uint32)
    return jnp.asarray(to4(seed1)), jnp.asarray(to4(base2))


def seed_planes_device(seed1_base, seed2_base, n: int):
    """Device twin of fake_seed_planes: s1 broadcast from the (4,) base,
    s2 = base + iota with 64-bit wraparound on 16-bit limb planes."""
    s1 = jnp.broadcast_to(seed1_base[:, None], (4, n)).astype(U32)
    iota = jax.lax.iota(U32, n)
    cols = [
        seed2_base[0] + (iota & MASK),
        jnp.broadcast_to(seed2_base[1], (n,)) + (iota >> 16),
        jnp.broadcast_to(seed2_base[2], (n,)),
        jnp.broadcast_to(seed2_base[3], (n,)),
    ]
    s2 = jnp.stack(_ripple(cols, 4))  # mod 2^64 wraparound (drop carry-out)
    return s1, s2


def gen_fake_cells_device(cell_size: int, seed: int, start_idx: int, n: int):
    """(n, cell_size) uint8 fake cells on device, == oracle slot.gen_fake_cell."""
    s1, s2 = fake_seed_planes(seed, start_idx, n)
    rows = gen_rows(s1, s2, cell_size)
    return rows.T  # (n, cell_size)
