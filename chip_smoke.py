"""Smoke test of the storage-proof data path on an NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded mesh path only

Phases, in one process (a JAX process reserves most of the card's memory,
so nothing here starts a second one):

  1. device   a GPU must be JAX's default device; prints the card's name
              and power limit (nvidia-smi).
  2. vectors  builds the CUDA kernels, runs the frozen vector suites
              (tests/vectors) through every kernel route at the 8192-lane
              chunk width, and every kernel against the plain jnp path.
  3. main     for each hash instance (BN254 Poseidon2, Goldilocks Poseidon2,
              Goldilocks Monolith), the CLI builds a 3-slot dataset of 1 GB
              slots (2048-byte cells, 64 KB blocks, fake data from a seed)
              and writes 117-sample proof inputs with --check, twice: cold
              and warm.  The proven slot's root must equal the one the
              native C library computes from the same seed.
  4. file     one 1 GB slot written to disk from the same seed, hashed
              through the CLI's --file path (BN254 and Goldilocks
              Poseidon2); its root must equal the fake-data root.

--four runs `four_cards`: the sharded dataset builds and proof inputs on
2x2 and 1x4 meshes of four cards (2 slots x 512 MB), each compared with
single-card streaming builds of the same slots in the same run.

All outputs are integers and every comparison is exact equality.  Any
failure exits non-zero before the result line; the last line of stdout is
{"ok": true, "device": {...}} only when every phase passed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

CELL, BLOCK, SLOT_CELLS, SAMPLES, SEED = 2048, 65536, 1 << 19, 117, 12345
ENTROPY = 1234567
INSTANCES = (("bn254", "poseidon2"), ("goldilocks", "poseidon2"), ("goldilocks", "monolith"))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(n_devices: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX's default device is {devs[0].platform})")
    if len(devs) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPUs, found {len(devs)}")
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    for line in r.stdout.strip().splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs


def phase_vectors(width: int = 8192) -> None:
    from codex_storage_proofs_circuits_tpu.ops import cuda_ffi, routes
    from codex_storage_proofs_circuits_tpu.utils import device_check

    t0 = time.perf_counter()
    path = cuda_ffi.library()
    log(f"vectors: CUDA kernels built/loaded in {time.perf_counter() - t0:.1f} s "
        f"({os.path.basename(path)}); routes {routes.describe()}")
    t0 = time.perf_counter()
    n = device_check.frozen_vectors(width)
    log(f"vectors: {n} frozen values exact at {width} lanes "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ops = device_check.kernels_vs_plain(width)
    log(f"vectors: kernel == plain jnp at {width} lanes for {', '.join(ops)} "
        f"({time.perf_counter() - t0:.1f} s)")


def run_cli(field: str, hash_fun: str, out: str, n_slots: int, index: int,
            data: list[str]) -> dict:
    from codex_storage_proofs_circuits_tpu.utils.cli import main

    argv = [f"--field={field}", f"--hash={hash_fun}", f"--cellsize={CELL}",
            f"--blocksize={BLOCK}", f"--ncells={SLOT_CELLS}", f"--nslots={n_slots}",
            f"--index={index}", f"--nsamples={SAMPLES}", f"--entropy={ENTROPY}",
            "--backend=device", "--check", f"--output={out}", *data]
    if main(argv) != 0:
        raise RuntimeError(f"cli {argv} failed")
    with open(out) as f:
        return json.load(f)


def slot_root(field: str, doc: dict):
    """The proven slot's root from an exported proof input (int or digest)."""
    v = doc["slotRoot"]
    return int(v) if field == "bn254" else tuple(int(x) for x in v)


def native_root(field: str, hash_fun: str, seed: int):
    from codex_storage_proofs_circuits_tpu import native

    if field == "bn254":
        data = native.fake_cells(CELL, seed, 0, SLOT_CELLS)
        _, big = native.slot_tree_from_bytes(data, CELL, BLOCK // CELL)
        return big[-1][0]
    btd = (BLOCK // CELL).bit_length() - 1
    return native.gl_slot_tree_layers(hash_fun, SLOT_CELLS, CELL, seed, btd)[-1][0]


def phase_main(workdir: str, n_slots: int = 3, index: int = 1) -> dict:
    from codex_storage_proofs_circuits_tpu.oracle.dataset import parametric_slot_seed
    from codex_storage_proofs_circuits_tpu.utils import cache

    roots = {}
    for field, hf in INSTANCES:
        name = f"{field}/{hf}"
        out = os.path.join(workdir, f"{field}_{hf}.json")
        t0 = time.perf_counter()
        doc = run_cli(field, hf, out, n_slots, index, [f"--seed={SEED}"])
        cold = time.perf_counter() - t0
        log(f"main {name}: cold {cold:.1f} s, AOT executables {dict(cache.AOT_STATS)}")
        cache._AOT_MEM.clear()  # the warm run reloads them from disk
        t0 = time.perf_counter()
        again = run_cli(field, hf, out, n_slots, index, [f"--seed={SEED}"])
        warm = time.perf_counter() - t0
        log(f"main {name}: warm {warm:.1f} s, AOT executables {dict(cache.AOT_STATS)}")
        if again != doc:
            raise AssertionError(f"{name}: warm proof input != cold proof input")
        got = slot_root(field, doc)
        t0 = time.perf_counter()
        want = native_root(field, hf, parametric_slot_seed(SEED, index))
        if got != want:
            raise AssertionError(f"{name}: slot root {got} != native {want}")
        log(f"main {name}: {n_slots} x 1 GB slots, {SAMPLES} samples, --check OK; "
            f"slot {index} root == native C root ({time.perf_counter() - t0:.1f} s)")
        roots[(field, hf)] = got
    return roots


def phase_file(workdir: str, roots: dict, index: int = 1) -> None:
    from codex_storage_proofs_circuits_tpu import native
    from codex_storage_proofs_circuits_tpu.oracle.dataset import parametric_slot_seed

    base = os.path.join(workdir, "slot.dat")
    data = native.fake_cells(CELL, parametric_slot_seed(SEED, index), 0, SLOT_CELLS)
    data.tofile(os.path.join(workdir, "slot0.dat"))  # slot 0 of a 1-slot dataset
    del data
    for field, hf in INSTANCES[:2]:
        out = os.path.join(workdir, f"file_{field}_{hf}.json")
        t0 = time.perf_counter()
        doc = run_cli(field, hf, out, 1, 0, [f"--file={base}"])
        got = slot_root(field, doc)
        if got != roots[(field, hf)]:
            raise AssertionError(f"file {field}/{hf}: root {got} != fake-data root")
        log(f"file {field}/{hf}: 1 GB slot file, --check OK, root == fake-data root "
            f"({time.perf_counter() - t0:.1f} s)")


def four_cards(n_cells: int = 1 << 18, n_slots: int = 2, cell: int = CELL,
               block: int = BLOCK, n_samples: int = SAMPLES) -> None:
    """Sharded proof inputs (BN254, Goldilocks Poseidon2) on 2x2 and 1x4
    meshes == single-card streaming proof inputs of the same dataset."""
    import jax

    from codex_storage_proofs_circuits_tpu.models.gl_proof_input import (
        generate_proof_input_gl_streaming,
    )
    from codex_storage_proofs_circuits_tpu.models.proof_input import (
        generate_proof_input_streaming,
    )
    from codex_storage_proofs_circuits_tpu.oracle.dataset import DataSetConfig, GlobalConfig
    from codex_storage_proofs_circuits_tpu.oracle.goldilocks import int_to_digest
    from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource
    from codex_storage_proofs_circuits_tpu.parallel import (
        make_mesh,
        sharded_gl_proof_input,
        sharded_proof_input,
    )

    glob = GlobalConfig(max_depth=32, max_log2_n_slots=8, cell_size=cell, block_size=block)
    dset = DataSetConfig(n_slots=n_slots, n_cells=n_cells, n_samples=n_samples,
                         data_src=DataSource("fake", seed=SEED))
    idx = n_slots - 1
    devs = jax.devices()[:4]
    total_mb = n_slots * n_cells * cell / 2**20
    chunk = min(1 << 13, n_cells // 2)
    cases = (
        ("bn254", lambda: generate_proof_input_streaming(glob, dset, idx, ENTROPY, chunk),
         lambda mesh: sharded_proof_input(glob, dset, idx, ENTROPY, mesh)),
        ("goldilocks/poseidon2",
         lambda: generate_proof_input_gl_streaming(
             "poseidon2", glob, dset, idx, int_to_digest(ENTROPY), chunk),
         lambda mesh: sharded_gl_proof_input(
             "poseidon2", glob, dset, idx, int_to_digest(ENTROPY), mesh)),
    )
    for name, single, sharded in cases:
        t0 = time.perf_counter()
        want = single()
        log(f"four {name}: single-card streaming build of {n_slots} slots "
            f"({total_mb:.0f} MB) in {time.perf_counter() - t0:.1f} s")
        for slots_shards, cells_shards in ((2, 2), (1, 4)):
            mesh = make_mesh(n_cells_shards=cells_shards, n_slot_shards=slots_shards,
                             devices=devs)
            t0 = time.perf_counter()
            got = sharded(mesh)
            if got != want:
                raise AssertionError(f"four {name}: mesh {dict(mesh.shape)} != single card")
            log(f"four {name}: mesh {dict(mesh.shape)} proof input (dataset root, "
                f"slot root, {n_samples} paths) == single card "
                f"({time.perf_counter() - t0:.1f} s)")


def main(argv: list[str]) -> int:
    four = "--four" in argv
    devs = phase_device(4 if four else 1)
    from codex_storage_proofs_circuits_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    if four:
        four_cards()
    else:
        phase_vectors()
        workdir = tempfile.mkdtemp(prefix="cspc_smoke_")
        try:
            roots = phase_main(workdir)
            phase_file(workdir, roots)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                             "kind": devs[0].device_kind,
                                             "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
