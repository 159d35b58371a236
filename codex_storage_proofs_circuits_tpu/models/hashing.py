"""Batched hashing pipeline pieces: permutation dispatch, cell hashing, and
power-of-two Merkle layer reduction on device.

Replaces the reference's per-cell host hashing loop
(reference/nim/proof_input/src/blocks/bn254.nim:23-29 hashCell;
merkle/bn254.nim:29-63 merkleTreeWorker) with whole-slot batched device ops:
one rate-2 sponge scan hashes every cell of a slot at once, and each Merkle
layer is one batched keyed compression over the full layer width.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import limbs as L
from ..ops import encode
from ..ops import poseidon2_jnp as P2
from ..ops import cuda_ffi, routes

NL = L.NL


def _kernel() -> bool:
    """True where the BN254 family runs the CUDA kernels (ops/routes.py)."""
    return routes.route("bn254") == "cuda"


def permute(state: jnp.ndarray) -> jnp.ndarray:
    """(3, NL, B) Montgomery batch -> permuted, by the family's route."""
    if _kernel():
        return cuda_ffi.bn254_permute(state)
    return P2.permutation(state)


def to_mont(x: jnp.ndarray) -> jnp.ndarray:
    """(NL, B) canonical -> Montgomery form, by the family's route."""
    if _kernel():
        return cuda_ffi.bn254_mont(x, to=True)
    return L.to_mont(x)


def from_mont(x: jnp.ndarray) -> jnp.ndarray:
    """(NL, B) Montgomery -> canonical form, by the family's route."""
    if _kernel():
        return cuda_ffi.bn254_mont(x, to=False)
    return L.from_mont(x)


def compress_layer(x: jnp.ndarray, y: jnp.ndarray, key: int) -> jnp.ndarray:
    """Batched keyed 2-to-1 compression, (NL, B) x (NL, B) -> (NL, B)."""
    b = x.shape[1]
    key_m = jnp.broadcast_to(jnp.asarray(P2.KEY_MONT[key]), (NL, b)).astype(jnp.uint32)
    return permute(jnp.stack([x, y, key_m]))[0]


def sponge2_scan(blocks: jnp.ndarray) -> jnp.ndarray:
    """Rate-2 sponge over pre-padded (nblocks, 2, NL, B) Montgomery blocks
    (semantics of ops.poseidon2_jnp.sponge2_absorb), one permute per block.
    """
    nb, two, nl, b = blocks.shape
    assert two == 2 and nl == NL
    iv = jnp.broadcast_to(jnp.asarray(P2.SPONGE2_IV_MONT), (NL, b)).astype(jnp.uint32)
    zero = jnp.zeros((NL, b), jnp.uint32)
    state = jnp.stack([zero, zero, iv])

    def body(st, blk):
        st = st.at[0].set(L.add_mod(st[0], blk[0]))
        st = st.at[1].set(L.add_mod(st[1], blk[1]))
        return permute(st), None

    state, _ = jax.lax.scan(body, state, blocks)
    return state[0]


def to_mont_stack(felts: jnp.ndarray) -> jnp.ndarray:
    """(K, NL, B) canonical -> Montgomery, as one batched (NL, K*B) mul."""
    k, nl, b = felts.shape
    assert nl == NL
    flat = jnp.moveaxis(felts, 0, 2).reshape(NL, b * k)  # (NL, B*K)
    mont = L.to_mont(flat).reshape(NL, b, k)
    return jnp.moveaxis(mont, 2, 0)  # (K, NL, B)


def hash_cells_mont(cells_felts: jnp.ndarray) -> jnp.ndarray:
    """(nfelts, NL, B) canonical felts (byte-encoded cells) -> (NL, B)
    Montgomery cell hashes (rate-2 sponge with felt `10*` padding).
    """
    if _kernel():
        return cuda_ffi.bn254_sponge(cells_felts)
    return sponge2_scan(P2.pad_felts_rate2(to_mont_stack(cells_felts)))


def encode_and_hash_cells(cells_u8: np.ndarray) -> jnp.ndarray:
    """(B, cell_size) raw cell bytes -> (NL, B) Montgomery cell hashes."""
    return hash_cells_mont(encode.encode_cells(cells_u8))


def _tail_reduce_scan(
    layer: jnp.ndarray, bottom_depths: tuple[int, ...], d0: int, n_steps: int
) -> jnp.ndarray:
    """All remaining layers of a narrow tree in ONE fixed-width scan.

    layer: (NL, T).  Step s compresses the valid prefix (width T/2^s) of a
    T-wide buffer whose stale suffix is zero — garbage columns hash
    harmlessly and are sliced off by the caller.  One permutation instance
    in the compiled program instead of one per depth (XLA:CPU compile of
    the permutation is ~15s per distinct batch width).
    """
    t = layer.shape[1]
    half = t // 2
    keys_np = np.stack(
        [P2.KEY_MONT[1 if (d0 + s) in bottom_depths else 0] for s in range(n_steps)]
    )  # (n_steps, NL, 1)
    keys = jnp.asarray(np.broadcast_to(keys_np, (n_steps, NL, half)).copy())

    def body(cur, key):
        trip = jnp.stack([cur[:, 0::2], cur[:, 1::2], key])
        out = permute(trip)[0]  # (NL, half)
        nxt = jnp.concatenate([out, jnp.zeros((NL, t - half), jnp.uint32)], axis=1)
        return nxt, out

    _, ys = jax.lax.scan(body, layer, keys)
    return ys  # (n_steps, NL, half); step s valid up to width t >> (s+1)


def tree_reduce_layers(
    leaves_mont: jnp.ndarray,
    bottom_depths: tuple[int, ...],
    stop_width: int = 1,
    tail_width: int = 512,
    depth_offset: int = 0,
) -> list[jnp.ndarray]:
    """Power-of-two Merkle reduction, keeping every layer (bottom first).

    leaves_mont: (NL, B) with B a power of two.  `bottom_depths` lists the
    depths whose compression uses the bottom-layer key (depth 0 for cell
    hashes, and again at the block-tree depth where block roots become the
    bottom layer of the slot tree — the flat layer stack of the two-stage
    cell->block->slot structure of reference/nim/proof_input/src/blocks/
    bn254.nim:60-67 + gen_input/bn254.nim:21-30).

    `stop_width` > 1 supports several independent same-shaped trees batched
    side-by-side on the lane axis: reduction stops at one node per tree
    instead of crossing tree boundaries (pairing never crosses a boundary
    because every tree's layer width is a power of two).

    Layers wider than `tail_width` compress one batched call per layer; the
    narrow tail collapses into a single fixed-width scan (_tail_reduce_scan).
    """
    b = leaves_mont.shape[1]
    assert b % stop_width == 0
    per = b // stop_width
    assert per & (per - 1) == 0, "tree_reduce_layers: width must be a power of two"
    layers = [leaves_mont]
    d = depth_offset
    cur = leaves_mont
    while cur.shape[1] > stop_width and cur.shape[1] > tail_width:
        key = 1 if d in bottom_depths else 0
        cur = compress_layer(cur[:, 0::2], cur[:, 1::2], key)
        layers.append(cur)
        d += 1
    t = cur.shape[1]
    n_steps = (t // stop_width).bit_length() - 1
    if n_steps > 0:
        ys = _tail_reduce_scan(cur, bottom_depths, d, n_steps)
        w = t
        for s in range(n_steps):
            w //= 2
            layers.append(ys[s][:, :w])
    return layers


def tree_reduce_general(leaves_mont: jnp.ndarray) -> list[jnp.ndarray]:
    """Full keyed Merkle build for ANY width >= 1, all layers kept.

    Device equivalent of oracle.merkle.merkle_tree (Merkle.hs:69-83,
    merkle/bn254.nim:29-63): odd trailing nodes compress against zero with
    the odd key; a singleton bottom still gets one bottom-odd compression.
    Widths are static under jit, so the odd/even branching unrolls at trace
    time.
    """
    layers = [leaves_mont]
    bottom = True
    while layers[-1].shape[1] > 1 or bottom:
        cur = layers[-1]
        w = cur.shape[1]
        half = w // 2
        parts = []
        if half:
            parts.append(
                compress_layer(cur[:, 0 : 2 * half : 2], cur[:, 1 : 2 * half : 2],
                               1 if bottom else 0)
            )
        if w % 2 == 1:
            zero = jnp.zeros((NL, 1), jnp.uint32)
            parts.append(compress_layer(cur[:, w - 1 : w], zero, 3 if bottom else 2))
        layers.append(parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1))
        bottom = False
    return layers


def extract_paths_device(
    layers: list[jnp.ndarray], indices: jnp.ndarray, max_depth: int
) -> jnp.ndarray:
    """Batched Merkle-path gather from a stored layer stack, on device.

    layers[d]: (NL, W >> d) with W a power of two (flat cell->block->slot
    stack, all widths powers of two so the sibling of node j at depth d is
    node j^1 — Slot.hs:181-187 semantics, vectorized over samples).
    indices: (S,) int32 leaf indices.  Returns (max_depth, NL, S) sibling
    planes, zero-padded beyond the tree depth (types.nim:27-37 padding).

    This replaces the scalar host gather of the round-1 path
    (per-host partitioned sampled-witness batches, SURVEY.md section 2c):
    under jit with sharded layers, XLA lowers the takes to collective
    gathers, so the same code serves the multi-chip path.
    """
    s = indices.shape[0]
    depth = len(layers) - 1
    out = []
    idx = indices.astype(jnp.int32)
    for d in range(max_depth):
        if d < depth and layers[d].shape[1] > 1:
            sib = jnp.take(layers[d], (idx >> d) ^ 1, axis=1)
        else:
            # beyond the real depth (or the appended singleton compression):
            # zero sibling
            sib = jnp.zeros((NL, s), jnp.uint32)
        out.append(sib)
    return jnp.stack(out)


@functools.partial(jax.jit, static_argnames=("block_tree_depth", "n_groups"))
def slot_tree_from_felts(
    cells_felts: jnp.ndarray, block_tree_depth: int, n_groups: int = 1
) -> list[jnp.ndarray]:
    """The full single-chip slot pipeline: encoded cells -> all tree layers.

    Returns the flat layer stack in *canonical* form, bottom (cell hashes)
    first, per-tree root(s) last.  Layer block_tree_depth holds the block
    roots.  `n_groups` independent same-shaped slots may be batched
    side-by-side on the lane axis.
    """
    hashes = hash_cells_mont(cells_felts)
    layers = tree_reduce_layers(
        hashes, bottom_depths=(0, block_tree_depth), stop_width=n_groups
    )
    return [from_mont(lyr) for lyr in layers]
