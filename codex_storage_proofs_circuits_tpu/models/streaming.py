"""Streaming (chunked) slot-tree construction with bounded host memory.

The reference materializes every cell of a slot before hashing
(reference/nim/proof_input/src/gen_input/bn254.nim:21-30); at 1 GB slots (and
the 8 TB ceiling of reference README.md:145-150) that is not viable.  Here
cells stream through the device in fixed-size chunks: each chunk is a
complete, aligned subtree of the slot tree (chunk size divides n_cells, both
powers of two), so its digest layers are exact contiguous segments of the
global layer stack.  Host memory is bounded by
one chunk of raw bytes; the device keeps only digest layers (32 B per node,
~2x the leaf count in total).

Pipelining: chunk k+1's bytes are generated/loaded on the host while chunk
k's hash+reduce runs on the device (JAX dispatch is async; the upload of
the next chunk's raw bytes overlaps the in-flight computation).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..oracle.slot import SlotConfig
from ..ops import limbs as L
from ..utils.cache import aot_call
from . import data as D
from . import hashing as H

NL = L.NL


# ---------------------------------------------------------------------------
# Checkpoint/resume of chunk subtree layers (SURVEY.md section 5: large
# builds checkpoint layer frontiers; the reference's resume story is file
# artifacts between process stages, workflow/PROOFS.md:136-161).


def _cfg_fingerprint(cfg: SlotConfig, chunk_cells: int) -> str:
    src = cfg.data_src
    key = json.dumps(
        [
            cfg.cell_size,
            cfg.block_size,
            cfg.n_cells,
            chunk_cells,
            src.kind,
            src.seed if src.kind == "fake" else src.filename,
        ]
    )
    return hashlib.sha256(key.encode()).hexdigest()[:16]


class ChunkCheckpoint:
    """Digest-layer checkpoint: one .npz per completed chunk + a manifest.

    Only digests are stored (32 B per node, ~2x leaf count in total), never
    raw cell data — a resumed build re-derives nothing that was finished.
    A manifest fingerprint ties the checkpoint to the exact slot config; a
    mismatch starts clean rather than resuming a different build.
    """

    def __init__(self, path: str, cfg: SlotConfig, chunk_cells: int):
        self.path = path
        self.fp = _cfg_fingerprint(cfg, chunk_cells)
        self.manifest_path = os.path.join(path, "manifest.json")
        os.makedirs(path, exist_ok=True)
        self.done: set[int] = set()
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    m = json.load(f)
                if m.get("fingerprint") == self.fp:
                    self.done = {
                        c
                        for c in m.get("chunks", [])
                        if os.path.exists(self._chunk_path(c))
                    }
            except (OSError, ValueError):
                pass

    def _chunk_path(self, c: int) -> str:
        return os.path.join(self.path, f"chunk_{c:06d}.npz")

    def load(self, c: int) -> list[jnp.ndarray]:
        with np.load(self._chunk_path(c)) as z:
            return [jnp.asarray(z[k]) for k in sorted(z.files)]

    def save(self, c: int, layers: list[jnp.ndarray]) -> None:
        tmp = self._chunk_path(c) + ".tmp"
        with open(tmp, "wb") as f:  # file handle: savez must not append .npz
            np.savez(
                f,
                **{
                    f"layer_{d:03d}": np.asarray(jax.device_get(x))
                    for d, x in enumerate(layers)
                },
            )
        os.replace(tmp, self._chunk_path(c))
        self.done.add(c)
        tmp_m = self.manifest_path + ".tmp"
        with open(tmp_m, "w") as f:
            json.dump({"fingerprint": self.fp, "chunks": sorted(self.done)}, f)
        os.replace(tmp_m, self.manifest_path)


@dataclass
class StreamingStats:
    """Per-stage wall-clock of a streaming build (observability, SURVEY §5)."""

    datagen_s: float = 0.0
    encode_s: float = 0.0
    device_s: float = 0.0  # dispatch of hash+reduce (async; excludes final sync)
    finalize_s: float = 0.0
    chunks: int = 0
    cells: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@functools.partial(jax.jit, static_argnames=("block_tree_depth",))
def _file_chunk(cells_u8, block_tree_depth: int):
    """One chunk of stored cells, (B, cell_size) uint8 on device -> byte pad
    -> felt encode -> rate-2 sponge -> subtree reduce; all layers."""
    from ..ops.encode import encode_cells_device

    return H.slot_tree_from_felts(encode_cells_device(cells_u8), block_tree_depth)


@functools.partial(jax.jit, static_argnames=("btd", "chunk_depth"))
def _chunk_tops_jit(chunk_roots_canonical, btd: int, chunk_depth: int):
    """Reduce the chunk-root layer to the slot root, all in one dispatch."""
    roots = H.to_mont(chunk_roots_canonical)
    tops = H.tree_reduce_layers(
        roots, bottom_depths=(0, btd), depth_offset=chunk_depth
    )
    return [H.from_mont(t) for t in tops[1:]]


@functools.partial(
    jax.jit, static_argnames=("cell_size", "block_tree_depth", "n")
)
def _fused_fake_chunk(seed1_base, seed2_base, cell_size, block_tree_depth, n):
    """One device dispatch for a whole fake-data chunk: seed planes -> PRNG
    -> byte pad -> felt encode -> rate-2 sponge -> subtree reduce.  The
    chunk takes only two (4,) seed-base vectors (32 B) and builds the
    per-cell seed planes on device."""
    from ..ops.encode import encode_cells_device
    from ..ops.fake_prng import gen_rows, seed_planes_device

    s1, s2 = seed_planes_device(seed1_base, seed2_base, n)
    rows = gen_rows(s1, s2, cell_size)  # (cell, B) u8
    felts = encode_cells_device(rows.T)
    return H.slot_tree_from_felts(felts, block_tree_depth)


def streaming_slot_layers(
    cfg: SlotConfig,
    chunk_cells: int = 1 << 13,
    stats: StreamingStats | None = None,
    checkpoint_dir: str | None = None,
    stop_after_chunks: int | None = None,
) -> list[jnp.ndarray] | None:
    """Full slot-tree layer stack (canonical limb planes), built in chunks.

    Returns layers[d] of shape (NL, n_cells >> d), layers[0] = cell hashes,
    layers[-1] = (NL, 1) slot root — identical to
    H.slot_tree_from_felts(all_cells) but with O(chunk) host memory.

    checkpoint_dir: persist each completed chunk's digest layers there and
    resume any matching prior build (ChunkCheckpoint).  stop_after_chunks
    aborts after that many newly-computed chunks and returns None — for
    testing resume, and for cooperative preemption in schedulers.
    """
    n_cells = cfg.n_cells
    btd = cfg.cells_per_block.bit_length() - 1
    if chunk_cells >= n_cells:
        chunk_cells = n_cells
    assert chunk_cells % cfg.cells_per_block == 0 or chunk_cells == n_cells
    assert n_cells % chunk_cells == 0
    assert chunk_cells & (chunk_cells - 1) == 0
    assert n_cells > cfg.cells_per_block, "streaming needs a multi-block slot"
    n_chunks = n_cells // chunk_cells
    chunk_depth = chunk_cells.bit_length() - 1
    st = stats if stats is not None else StreamingStats()

    ckpt = (
        ChunkCheckpoint(checkpoint_dir, cfg, chunk_cells) if checkpoint_dir else None
    )
    new_chunks = 0
    # per-depth segment lists for the in-chunk layers
    segments: list[list[jnp.ndarray]] = [[] for _ in range(chunk_depth + 1)]
    for c in range(n_chunks):
        if ckpt is not None and c in ckpt.done:
            for d, lyr in enumerate(ckpt.load(c)):
                segments[d].append(lyr)
            st.chunks += 1
            st.cells += chunk_cells
            continue
        if stop_after_chunks is not None and new_chunks >= stop_after_chunks:
            return None
        t0 = time.perf_counter()
        if cfg.data_src.kind == "fake":
            # fully on-device and fused: seed planes + PRNG + padding +
            # encode + sponge + subtree reduce in one dispatch
            from ..ops.fake_prng import fake_seed_bases

            s1, s2 = fake_seed_bases(cfg.data_src.seed, c * chunk_cells)
            t1 = t2 = time.perf_counter()
            # aot_call: a fresh process reloads the compiled chunk program
            # without tracing and lowering it again
            layers = aot_call(
                _fused_fake_chunk,
                "fused_fake_chunk",
                (s1, s2),
                (cfg.cell_size, btd, chunk_cells),
            )
        else:
            idx = np.arange(c * chunk_cells, (c + 1) * chunk_cells)
            cells = D.load_cells(cfg, idx)
            t1 = time.perf_counter()
            cells_dev = jnp.asarray(cells)
            t2 = time.perf_counter()
            layers = _file_chunk(cells_dev, btd)
        for d, lyr in enumerate(layers):
            segments[d].append(lyr)
        t3 = time.perf_counter()
        if ckpt is not None:
            ckpt.save(c, layers)
        st.datagen_s += t1 - t0
        st.encode_s += t2 - t1
        st.device_s += t3 - t2
        st.chunks += 1
        st.cells += chunk_cells
        new_chunks += 1

    t0 = time.perf_counter()
    out = [
        seglist[0] if len(seglist) == 1 else jnp.concatenate(seglist, axis=1)
        for seglist in segments
    ]
    if n_chunks > 1:
        # reduce the chunk roots; keys follow the global depth schedule,
        # in one dispatch
        out.extend(aot_call(_chunk_tops_jit, "chunk_tops", (out[-1],), (btd, chunk_depth)))
    out[-1].block_until_ready()
    st.finalize_s += time.perf_counter() - t0
    return out


def streaming_slot_root(
    cfg: SlotConfig, chunk_cells: int = 1 << 13, stats: StreamingStats | None = None
) -> int:
    """Slot root only (python int), via the chunked build."""
    layers = streaming_slot_layers(cfg, chunk_cells, stats)
    return L.unpack(layers[-1])[0]


# ---------------------------------------------------------------------------
# Goldilocks streaming twin (the reference's default field).  Same chunked
# aligned-subtree structure; digest layers are (4 lanes, 4 limbs, W).


@functools.partial(
    jax.jit, static_argnames=("hash_fun", "cell_size", "block_tree_depth", "n")
)
def _fused_fake_chunk_gl(seed1_base, seed2_base, hash_fun, cell_size, block_tree_depth, n):
    """One device dispatch per fake-data chunk: seed planes -> PRNG -> byte
    pad -> 62-byte felt encode -> rate-8 sponge -> subtree reduce (GL digest
    layers).  Takes 32 B seed bases like _fused_fake_chunk."""
    from ..ops.fake_prng import gen_rows, seed_planes_device

    s1, s2 = seed_planes_device(seed1_base, seed2_base, n)
    rows = gen_rows(s1, s2, cell_size)  # (cell, B)
    return _gl_chunk_layers(rows, hash_fun, cell_size, block_tree_depth)


def _gl_chunk_layers(rows, hash_fun, cell_size, block_tree_depth):
    """(cell_size, B) uint8 byte rows -> GL digest layers of the chunk."""
    from ..ops.gl_encode import encode_cells_gl_device
    from ..parallel.gl_tree import gl_tree_reduce_layers
    from . import gl_hashing as GH

    felts = encode_cells_gl_device(rows, cell_size)
    hashes = GH.sponge_digests(hash_fun, felts)
    return gl_tree_reduce_layers(hashes, hash_fun, (0, block_tree_depth))


_file_chunk_gl = jax.jit(
    _gl_chunk_layers, static_argnames=("hash_fun", "cell_size", "block_tree_depth")
)


@functools.partial(jax.jit, static_argnames=("hash_fun", "btd", "chunk_depth"))
def _chunk_tops_gl_jit(chunk_roots, hash_fun, btd: int, chunk_depth: int):
    from ..parallel.gl_tree import gl_tree_reduce_layers

    return gl_tree_reduce_layers(
        chunk_roots, hash_fun, (0, btd), depth_offset=chunk_depth
    )[1:]


def streaming_slot_layers_gl(
    cfg: SlotConfig,
    hash_fun: str = "poseidon2",
    chunk_cells: int = 1 << 13,
    stats: StreamingStats | None = None,
) -> list[jnp.ndarray]:
    """GL slot-tree digest layer stack, built in bounded-memory chunks.

    Returns layers[d] of shape (4, 4, n_cells >> d) (canonical), identical
    to models/gl_hashing.slot_tree_from_felts_gl on the whole slot.
    """
    n_cells = cfg.n_cells
    btd = cfg.cells_per_block.bit_length() - 1
    if chunk_cells >= n_cells:
        chunk_cells = n_cells
    assert n_cells % chunk_cells == 0
    assert chunk_cells & (chunk_cells - 1) == 0
    n_chunks = n_cells // chunk_cells
    chunk_depth = chunk_cells.bit_length() - 1
    st = stats if stats is not None else StreamingStats()

    segments: list[list[jnp.ndarray]] = [[] for _ in range(chunk_depth + 1)]
    for c in range(n_chunks):
        t0 = time.perf_counter()
        if cfg.data_src.kind == "fake":
            from ..ops.fake_prng import fake_seed_bases

            s1, s2 = fake_seed_bases(cfg.data_src.seed, c * chunk_cells)
            t1 = time.perf_counter()
            layers = aot_call(
                _fused_fake_chunk_gl,
                "fused_fake_chunk_gl",
                (s1, s2),
                (hash_fun, cfg.cell_size, btd, chunk_cells),
            )
        else:
            idx = np.arange(c * chunk_cells, (c + 1) * chunk_cells)
            cells = D.load_cells(cfg, idx)
            t1 = time.perf_counter()
            layers = _file_chunk_gl(jnp.asarray(cells.T), hash_fun, cfg.cell_size, btd)
        for d, lyr in enumerate(layers):
            segments[d].append(lyr)
        st.datagen_s += t1 - t0
        st.device_s += time.perf_counter() - t1
        st.chunks += 1
        st.cells += chunk_cells

    t0 = time.perf_counter()
    out = [
        seg[0] if len(seg) == 1 else jnp.concatenate(seg, axis=2) for seg in segments
    ]
    if n_chunks > 1:
        out.extend(
            aot_call(
                _chunk_tops_gl_jit,
                "chunk_tops_gl",
                (out[-1],),
                (hash_fun, btd, chunk_depth),
            )
        )
    out[-1].block_until_ready()
    st.finalize_s += time.perf_counter() - t0
    return out


def streaming_slot_root_gl(
    cfg: SlotConfig,
    hash_fun: str = "poseidon2",
    chunk_cells: int = 1 << 13,
    stats: StreamingStats | None = None,
) -> tuple:
    """GL slot root (Digest tuple of python ints), via the chunked build."""
    import jax as _jax

    layers = streaming_slot_layers_gl(cfg, hash_fun, chunk_cells, stats)
    arr = np.asarray(_jax.device_get(layers[-1]))
    return tuple(
        int(sum(int(arr[j, l, 0]) << (16 * l) for l in range(4))) for j in range(4)
    )
