"""Scaling harness: sharded dataset build at 1..N devices, efficiency report.

Runs the full sharded (slots x cells) dataset build over meshes of
increasing device count and reports wall-clock + parallel efficiency vs the
1-device run, for both fields.  On several GPUs this measures scaling over
the cards' links; on a CPU host it exercises the identical SPMD programs
over virtual devices (mechanism check, not a hardware claim — XLA:CPU
executes virtual devices on a thread pool, so efficiency also reflects host
core count).

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/scaling_bench.py --out scaling.json [--cells 4096] [--slots 4]

Prints a JSON line per mesh size and writes a summary to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from codex_storage_proofs_circuits_tpu.utils.cache import set_default_cache_env

set_default_cache_env()

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=4096, help="cells per slot")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cell-size", type=int, default=256)
    ap.add_argument("--field", choices=["bn254", "goldilocks", "both"], default="both")
    ap.add_argument("--out", required=True, help="summary JSON file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from codex_storage_proofs_circuits_tpu.models import data as D
    from codex_storage_proofs_circuits_tpu.models.gl_hashing import encode_cells_gl
    from codex_storage_proofs_circuits_tpu.ops.encode import encode_cells
    from codex_storage_proofs_circuits_tpu.oracle.dataset import (
        DataSetConfig,
        GlobalConfig,
        slot_cfg_from_dataset_cfg,
    )
    from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource
    from codex_storage_proofs_circuits_tpu.parallel import make_mesh
    from codex_storage_proofs_circuits_tpu.parallel.gl_tree import (
        sharded_gl_dataset_build,
    )
    from codex_storage_proofs_circuits_tpu.parallel.tree import sharded_dataset_build

    devs = jax.devices()
    print(f"# backend={jax.default_backend()} devices={len(devs)}", file=sys.stderr)

    glob = GlobalConfig(
        max_depth=32, max_log2_n_slots=8, cell_size=args.cell_size,
        block_size=args.cell_size * 8,
    )
    dset = DataSetConfig(
        n_slots=args.slots, n_cells=args.cells, n_samples=1,
        data_src=DataSource("fake", seed=7),
    )
    cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]
    btd = cfgs[0].cells_per_block.bit_length() - 1
    cells_np = [D.load_slot_cells(c) for c in cfgs]

    fields = ["bn254", "goldilocks"] if args.field == "both" else [args.field]
    enc = {}
    if "bn254" in fields:
        enc["bn254"] = np.stack([np.asarray(encode_cells(c)) for c in cells_np])
    if "goldilocks" in fields:
        enc["goldilocks"] = np.stack(
            [np.asarray(jax.device_get(encode_cells_gl(c))) for c in cells_np]
        )

    sizes = []
    n = 1
    while n <= len(devs):
        sizes.append(n)
        n *= 2

    results = {}
    for field in fields:
        base = None
        rows = []
        for nd in sizes:
            n_slot_shards = 2 if nd >= 4 else 1
            n_cell_shards = nd // n_slot_shards
            if dset.n_slots % n_slot_shards or args.cells % n_cell_shards:
                continue
            mesh = make_mesh(
                n_cells_shards=n_cell_shards, n_slot_shards=n_slot_shards,
                devices=devs[:nd],
            )
            felts = jnp.asarray(enc[field])
            build = (
                sharded_dataset_build if field == "bn254" else
                lambda f, m, b, n_slots: sharded_gl_dataset_build(
                    f, m, "poseidon2", b, n_slots=n_slots
                )
            )
            out = build(felts, mesh, btd, dset.n_slots)
            jax.block_until_ready(out[2])  # compile + first run
            best = 1e9
            for _ in range(3):
                t0 = time.perf_counter()
                out = build(felts, mesh, btd, dset.n_slots)
                jax.block_until_ready(out[2])
                best = min(best, time.perf_counter() - t0)
            if base is None:
                base = best
            eff = base / (best * nd)
            row = {
                "field": field, "devices": nd,
                "mesh": {"slots": n_slot_shards, "cells": n_cell_shards},
                "wall_s": round(best, 4), "speedup": round(base / best, 3),
                "efficiency": round(eff, 3),
            }
            rows.append(row)
            print(json.dumps(row))
        results[field] = rows

    caveat = None
    if jax.default_backend() == "cpu":
        caveat = (
            "virtual CPU devices share one host's cores: these numbers are a "
            "mechanism check of the SPMD programs, not a scaling measurement"
        )
    with open(args.out, "w") as f:
        json.dump(
            {"backend": jax.default_backend(), "caveat": caveat, "results": results},
            f,
            indent=1,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
