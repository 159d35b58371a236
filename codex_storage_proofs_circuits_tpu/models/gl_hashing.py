"""Batched Goldilocks device pipeline: cell encode -> digests -> trees.

The GL twin of models/hashing.py + models/slot_tree.py: every cell of every
slot is 62-byte-chunk encoded, sponged (rate-8) and Merkle-reduced in
batched device ops (ops/goldilocks_jnp.py), replacing the reference's
per-cell host loop (reference/nim/proof_input/src/blocks/goldilocks.nim:18-74,
gen_input/goldilocks.nim:22-33).  Layers come back as oracle MerkleTree /
SlotTree objects so path extraction and proof-input assembly reuse the
oracle code paths unchanged (bit-exactness by construction).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..oracle.slot import SlotConfig, SlotTree
from ..oracle.merkle import MerkleTree
from ..oracle.goldilocks import CHUNK_BYTES_GL
from ..ops import goldilocks_jnp as GJ
from ..ops import cuda_ffi, routes
from . import data as D

NL = GJ.NL  # 4 x 16-bit limbs per felt
FELTS_PER_DIGEST = 4


def _kernel() -> bool:
    """True where the Goldilocks family runs the CUDA kernels (ops/routes.py)."""
    return routes.route("gl") == "cuda"


def sponge_digests(hash_fun: str, felts: jnp.ndarray) -> jnp.ndarray:
    """(n, 4, B) felts -> (4, 4, B) digests, by the family's route."""
    if _kernel():
        return cuda_ffi.gl_sponge(hash_fun, felts)
    return GJ.sponge_digest_felts(hash_fun, felts)


def compress_digests(
    hash_fun: str, key: int, x: jnp.ndarray, y: jnp.ndarray
) -> jnp.ndarray:
    """Keyed digest compression, by the family's route."""
    if _kernel():
        return cuda_ffi.gl_compress(hash_fun, key, x, y)
    return GJ.compress_batch(hash_fun, key, x, y)


def encode_cells_gl(cells_u8: np.ndarray) -> jnp.ndarray:
    """(B, cell_size) raw bytes -> (nfelts, 4, B) uint32 felt limb planes.

    62-byte chunks with `10*` byte padding, each chunk little-endian split
    into 8 felts of 62 bits (oracle bytes_to_felts_gl,
    json/goldilocks.nim:19-25) — vectorized across cells.
    """
    b, cs = cells_u8.shape
    padded_len = cs + 1
    padded_len += (-padded_len) % CHUNK_BYTES_GL
    buf = np.zeros((b, padded_len), np.uint8)
    buf[:, :cs] = cells_u8
    buf[:, cs] = 1
    n_chunks = padded_len // CHUNK_BYTES_GL
    chunks = buf.reshape(b, n_chunks, CHUNK_BYTES_GL)
    # 62 bytes -> 8 x 62-bit felts, little-endian: felt j covers bit range
    # [62j, 62j+62).  Collect per-felt 16-bit limbs via python-int bigints on
    # a per-chunk-column basis (vectorized with object math would be slow;
    # use exact byte/shift arithmetic on uint64 lanes instead).
    nf = n_chunks * 8
    out = np.zeros((nf, NL, b), np.uint32)
    # view each 62-byte chunk as 8 little-endian uint64 windows with shifts:
    # felt j starts at bit 62j = byte 7j + bit (62j - 56j = 6j... general)
    for j in range(8):
        bit0 = 62 * j
        byte0 = bit0 // 8
        shift = bit0 % 8
        # read 9 bytes to cover 62 bits + up to 7 bits of shift
        window = np.zeros((b, n_chunks, 9), np.uint8)
        avail = min(9, CHUNK_BYTES_GL - byte0)
        window[:, :, :avail] = chunks[:, :, byte0 : byte0 + avail]
        vals = np.zeros((b, n_chunks), np.uint64)
        for k in range(8):
            vals |= window[:, :, k].astype(np.uint64) << np.uint64(8 * k)
        vals >>= np.uint64(shift)
        hi = (window[:, :, 8].astype(np.uint64) << np.uint64(64 - shift)) if shift else 0
        with np.errstate(over="ignore"):
            vals = (vals | hi) & np.uint64((1 << 62) - 1)
        for l in range(NL):
            out[j::8, l, :] = ((vals >> np.uint64(16 * l)) & np.uint64(0xFFFF)).T.astype(
                np.uint32
            )
    return jnp.asarray(out)


def _compress_layer(hash_fun: str, cur: jnp.ndarray, key: int) -> jnp.ndarray:
    """(4, 4, W) digest layer -> (4, 4, W/2) via batched keyed compression."""
    return compress_digests(hash_fun, key, cur[:, :, 0::2], cur[:, :, 1::2])


@functools.partial(jax.jit, static_argnames=("hash_fun", "block_tree_depth", "n_groups"))
def slot_tree_from_felts_gl(
    hash_fun: str, cells_felts: jnp.ndarray, block_tree_depth: int, n_groups: int = 1
) -> list[jnp.ndarray]:
    """Encoded cells -> all flat tree layers (cell digests first, roots last).

    cells_felts: (nfelts, 4, B); layer d has shape (4, 4, B >> d).  Key
    schedule matches the flat cell->block->slot stack (bottom key at depth 0
    and at block_tree_depth; merkle/goldilocks/*.nim:14-63).  `n_groups`
    same-shaped slots may be batched side-by-side on the lane axis.
    """
    hashes = sponge_digests(hash_fun, cells_felts)  # (4, 4, B)
    layers = [hashes]
    d = 0
    while layers[-1].shape[2] > n_groups:
        key = 1 if d in (0, block_tree_depth) else 0
        layers.append(_compress_layer(hash_fun, layers[-1], key))
        d += 1
    return layers


def _digests_np(layer: np.ndarray) -> list[tuple]:
    """(4, 4, W) limb planes -> list of W Digest tuples of python ints."""
    f, nl, w = layer.shape
    out = []
    for i in range(w):
        out.append(
            tuple(
                int(sum(int(layer[j, l, i]) << (16 * l) for l in range(nl)))
                for j in range(f)
            )
        )
    return out


def build_slot_trees_gl(hash_fun: str, cfgs: list[SlotConfig]) -> list[SlotTree]:
    """Device-batched GL slot trees for identically-shaped slots, returned as
    oracle SlotTree objects (mini block trees + big tree) for reuse of the
    oracle's path extraction."""
    assert cfgs
    cfg0 = cfgs[0]
    for c in cfgs:
        assert (c.cell_size, c.block_size, c.n_cells) == (
            cfg0.cell_size,
            cfg0.block_size,
            cfg0.n_cells,
        )
    btd = cfg0.cells_per_block.bit_length() - 1
    cells = np.concatenate([D.load_slot_cells(c) for c in cfgs], axis=0)
    felts = encode_cells_gl(cells)
    layers_dev = slot_tree_from_felts_gl(hash_fun, felts, btd, n_groups=len(cfgs))
    layers_np = [np.asarray(jax.device_get(l)) for l in layers_dev]

    k = cfg0.cells_per_block
    trees: list[SlotTree] = []
    for s in range(len(cfgs)):
        per = [
            _digests_np(l[:, :, s * (l.shape[2] // len(cfgs)) : (s + 1) * (l.shape[2] // len(cfgs))])
            for l in layers_np
        ]
        n_blocks = cfg0.n_cells // k
        minis = []
        for bi in range(n_blocks):
            mlayers = []
            for d in range(btd + 1):
                w = k >> d
                mlayers.append(per[d][bi * w : (bi + 1) * w])
            minis.append(MerkleTree(mlayers))
        big_layers = [per[d] for d in range(btd, len(per))]
        if n_blocks == 1:
            # singleton big tree: one bottom-odd compression on top
            from ..oracle.goldilocks import compress as gl_compress

            big_layers = [big_layers[0], [gl_compress(hash_fun, 3, big_layers[0][0],
                                                      (0, 0, 0, 0))]]
        big = MerkleTree(big_layers)
        trees.append(SlotTree(minis, big))
    return trees


def extract_gl_paths_device(
    layers: list[jnp.ndarray], indices: jnp.ndarray, max_depth: int
) -> jnp.ndarray:
    """Batched GL Merkle-path gather from a flat digest layer stack.

    layers[d]: (4, 4, W >> d) with W a power of two; indices: (S,) int32.
    Returns (max_depth, 4, 4, S) sibling digests, zero-padded beyond the
    tree depth (GL twin of models/hashing.extract_paths_device).
    """
    s = indices.shape[0]
    depth = len(layers) - 1
    idx = indices.astype(jnp.int32)
    out = []
    for d in range(max_depth):
        if d < depth and layers[d].shape[2] > 1:
            sib = jnp.take(layers[d], (idx >> d) ^ 1, axis=2)
        else:
            sib = jnp.zeros((FELTS_PER_DIGEST, NL, s), jnp.uint32)
        out.append(sib)
    return jnp.stack(out)
