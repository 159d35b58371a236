"""Benchmark: hash kernels at the chunk width and 1 GB slot-root builds.

    python bench.py [--phases kernels,slots] [--plain-slots] [--out FILE]
    JAX_PLATFORMS=cpu python bench.py --small      # tiny sizes, CPU check

Phases:
  kernels  every hash/PRNG operation on one 8192-lane chunk (a 2048-byte
           cell per lane), through its kernel route and through the plain
           jnp path XLA compiles (ops/routes.py): median device time of
           warm calls, each closed by block_until_ready.
  slots    the streaming 1 GB slot-root build (524288 cells of 2048 B,
           64 KB blocks, fake data from a seed) for BN254 Poseidon2,
           Goldilocks Poseidon2 and Monolith: cold (first build in the
           process, compiles included) and two warm wall times, kernel
           routes.  --plain-slots also builds each slot with one kernel
           family on the plain path at a time (the hash family, then the
           PRNG), which is each kernel's end-to-end comparison.

Without --small the run needs a GPU and fails on any other backend; any
failed phase fails the run.  Prints one JSON object as its last line (and
writes it to --out if given), with the device as JAX reports it and the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SLOT_CELLS = 1 << 19  # 1 GB of 2048-byte cells
CHUNK = 1 << 13


def card() -> str:
    """nvidia-smi's name and power limit of the card(s), or why not."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def _time(fn, reps: int) -> float:
    """Median seconds of `reps` warm calls of fn, each ended on the device."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def bench_kernels(width: int, cell: int, reps: int) -> dict:
    """Kernel route vs plain path per operation, on one chunk of lanes."""
    import jax
    import jax.numpy as jnp

    from codex_storage_proofs_circuits_tpu.models import gl_hashing as GH
    from codex_storage_proofs_circuits_tpu.models import hashing as H
    from codex_storage_proofs_circuits_tpu.ops import fake_prng as F
    from codex_storage_proofs_circuits_tpu.ops import routes

    rng = np.random.default_rng(0)

    def planes(shape, top):
        x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
        x[..., -1, :] &= top
        return jnp.asarray(x)

    bn_nf = -(-(cell + 1) // 31)
    gl_nf = 8 * -(-(cell + 1) // 62)
    bn_state = planes((3, 16, width), 0x2FFF)
    bn_felts = planes((bn_nf, 16, width), 0x00FF)
    gl_felts = planes((gl_nf, 4, width), 0x3FFF)
    gl_x, gl_y = planes((4, 4, width), 0x7FFF), planes((4, 4, width), 0x7FFF)
    s1, s2 = F.fake_seed_planes(12345, 0, width)

    cases = [
        ("prng", "fake_prng", lambda: F.gen_rows(s1, s2, cell)),
        ("bn254", "bn254_cell_sponge", lambda: H.hash_cells_mont(bn_felts)),
        ("bn254", "bn254_permute", lambda: H.permute(bn_state)),
    ]
    for hf in ("poseidon2", "monolith"):
        cases += [
            ("gl", f"gl_{hf}_cell_sponge", lambda hf=hf: GH.sponge_digests(hf, gl_felts)),
            ("gl", f"gl_{hf}_compress",
             lambda hf=hf: GH.compress_digests(hf, 1, gl_x, gl_y)),
        ]
    out = {}
    for fam, name, fn in cases:
        row = {}
        for label, route in (("kernel", routes.GPU_ROUTES[fam]), ("plain", "jnp")):
            with routes.use(**{fam: route}):
                jitted = jax.jit(fn)
                t0 = time.perf_counter()
                jax.block_until_ready(jitted())
                row[f"{label}_first_call_s"] = time.perf_counter() - t0
                row[f"{label}_s"] = _time(jitted, reps)
        row["speedup"] = row["plain_s"] / row["kernel_s"]
        out[name] = row
        print(f"# kernels {name}: {row}", file=sys.stderr, flush=True)
    return out


def bench_slots(n_cells: int, cell: int, block: int, chunk: int, plain: bool) -> dict:
    """Cold and warm streaming slot-root builds per hash instance."""
    from codex_storage_proofs_circuits_tpu.models.streaming import (
        streaming_slot_root,
        streaming_slot_root_gl,
    )
    from codex_storage_proofs_circuits_tpu.ops import routes
    from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig

    cfg = SlotConfig(cell_size=cell, block_size=block, n_cells=n_cells,
                     n_samples=1, data_src=DataSource("fake", seed=12345))
    instances = {
        "bn254": lambda: streaming_slot_root(cfg, chunk_cells=chunk),
        "gl_poseidon2": lambda: streaming_slot_root_gl(cfg, "poseidon2", chunk_cells=chunk),
        "gl_monolith": lambda: streaming_slot_root_gl(cfg, "monolith", chunk_cells=chunk),
    }
    hash_family = {"bn254": "bn254", "gl_poseidon2": "gl", "gl_monolith": "gl"}
    out = {"slot_bytes": cell * n_cells, "chunk_cells": chunk}
    for name, build in instances.items():
        variants = [("kernel", {})]
        if plain:
            variants += [(f"plain_{hash_family[name]}", {hash_family[name]: "jnp"}),
                         ("plain_prng", {"prng": "jnp"})]
        for label, chosen in variants:
            with routes.use(**chosen):
                t0 = time.perf_counter()
                root = build()
                row = {"cold_s": time.perf_counter() - t0, "warm_s": []}
                for _ in range(2):
                    t0 = time.perf_counter()
                    if build() != root:
                        raise AssertionError(f"{name} {label}: warm root != cold root")
                    row["warm_s"].append(time.perf_counter() - t0)
            row["root"] = str(root)
            if row["root"] != out.get(f"{name}_kernel", row)["root"]:
                raise AssertionError(f"{name} {label}: root != kernel-route root")
            out[f"{name}_{label}"] = row
            print(f"# slots {name} {label}: cold {row['cold_s']:.3f} s "
                  f"warm {row['warm_s']}", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,slots")
    ap.add_argument("--plain-slots", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes; the only mode allowed off the GPU")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)

    import jax

    from codex_storage_proofs_circuits_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.small:
        print(f"no GPU (platform {dev.platform}); use --small off the GPU",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    phases = args.phases.split(",")
    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card() if dev.platform == "gpu" else None,
    }
    if "kernels" in phases:
        result["kernels"] = bench_kernels(
            width=64 if args.small else CHUNK, cell=256 if args.small else 2048,
            reps=2 if args.small else 10,
        )
    if "slots" in phases:
        if args.small:
            result["slots"] = bench_slots(64, 256, 2048, 32, args.plain_slots)
        else:
            result["slots"] = bench_slots(SLOT_CELLS, 2048, 65536, CHUNK, args.plain_slots)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
