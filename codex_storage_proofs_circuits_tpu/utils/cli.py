"""Command-line driver.

Mirrors the reference CLI's flag surface and defaults
(reference/nim/proof_input/src/cli.nim:80-105,47-76), with one addition:
`--backend` selects the compute path (oracle = pure-Python CPU reference,
device = JAX pipeline on the default JAX device, native = C host library).

Example:
    cspc-tpu -v --field=bn254 --nslots=5 --ncells=64 --nsamples=5 \
             --output=input.json --circom=proof_main.circom
"""

from __future__ import annotations

import argparse
import sys
import time

from ..oracle.slot import DataSource
from ..oracle.dataset import GlobalConfig, DataSetConfig


def _ceiling_log2(x: int) -> int:
    # misc.nim:18-22 convention: ceilingLog2(0) = -1
    if x == 0:
        return -1
    return (x - 1).bit_length()


def _check_power_of_two(x: int, what: str) -> int:
    if x <= 0 or x & (x - 1):
        raise SystemExit(f"`{what}` is expected to be a power of 2 (got {x})")
    return x


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cspc-tpu",
        description="Codex storage-proof input generator on a JAX device",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--depth", type=int, default=32,
                   help="maximum depth of the slot tree (eg. 32)")
    p.add_argument("-N", "--maxslots", type=int, default=256,
                   help="maximum number of slots (eg. 256)")
    p.add_argument("-c", "--cellsize", type=int, default=2048,
                   help="cell size in bytes (eg. 2048)")
    p.add_argument("-b", "--blocksize", type=int, default=65536,
                   help="block size in bytes (eg. 65536)")
    p.add_argument("-s", "--nslots", type=int, default=11,
                   help="number of slots in the dataset (eg. 13)")
    p.add_argument("-n", "--nsamples", type=int, default=5,
                   help="number of samples we prove (eg. 100)")
    p.add_argument("-e", "--entropy", type=int, default=1234567,
                   help="external randomness (eg. 1234567)")
    p.add_argument("-S", "--seed", type=int, default=12345,
                   help="seed to generate the fake data (eg. 12345)")
    p.add_argument("-f", "--file", type=str, default=None,
                   help='slot data file base name ("slotdata" means "slotdata5.dat" for slot 5)')
    p.add_argument("-i", "--index", type=int, default=0,
                   help="index of the slot (within the dataset) we prove")
    p.add_argument("-k", "--log2ncells", type=int, default=None,
                   help="log2 of the number of cells inside this slot (eg. 10)")
    p.add_argument("-K", "--ncells", type=int, default=256,
                   help="number of cells inside this slot (power of two)")
    p.add_argument("-o", "--output", type=str, default=None,
                   help="JSON file into which we write the proof input")
    p.add_argument("-C", "--circom", type=str, default=None,
                   help="circom main component to create with these parameters")
    p.add_argument("-F", "--field", type=str, default="goldilocks",
                   choices=["bn254", "goldilocks"],
                   help="the underlying field (default matches the reference "
                        "cli.nim:47-51: goldilocks)")
    p.add_argument("-H", "--hash", type=str, default="poseidon2",
                   choices=["poseidon2", "monolith"],
                   help="the hash function to use")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "oracle", "device", "native"],
                   help="compute path: pure-Python oracle, JAX device pipeline, or C host library")
    p.add_argument("--check", action="store_true",
                   help="after generation, re-verify the witness against the circuit semantics")
    return p


def configs_from_args(args) -> tuple[GlobalConfig, DataSetConfig]:
    n_cells = args.ncells
    if args.log2ncells is not None:
        n_cells = 1 << args.log2ncells
    _check_power_of_two(args.cellsize, "cellSize")
    _check_power_of_two(args.blocksize, "blockSize")
    _check_power_of_two(n_cells, "nCells")
    glob = GlobalConfig(
        max_depth=args.depth,
        max_log2_n_slots=_ceiling_log2(args.maxslots),
        cell_size=args.cellsize,
        block_size=args.blocksize,
    )
    if args.file is not None:
        src = DataSource("file", filename=args.file)
    else:
        src = DataSource("fake", seed=args.seed)
    dset = DataSetConfig(
        n_slots=args.nslots,
        n_cells=n_cells,
        n_samples=args.nsamples,
        data_src=src,
    )
    return glob, dset


def main(argv=None) -> int:
    # persistent XLA compile cache (utils/cache.py): later runs skip the
    # compiles of the device pipeline
    from .cache import enable_compile_cache

    enable_compile_cache()

    args = build_parser().parse_args(argv)

    # combo validation (types.nim:93-109: Monolith is Goldilocks-only)
    if args.field == "bn254" and args.hash != "poseidon2":
        raise SystemExit(f"hash `{args.hash}` is not available over bn254")
    if not (0 <= args.index < args.nslots):
        raise SystemExit(
            f"slot index {args.index} out of range (dataset has {args.nslots} slots)"
        )

    glob, dset = configs_from_args(args)

    if args.verbose:
        print(f"field      = {args.field}")
        print(f"hash func. = {args.hash}")
        print(f"backend    = {args.backend}")
        print(f"maxDepth   = {glob.max_depth}")
        print(f"maxSlots   = {1 << glob.max_log2_n_slots}")
        print(f"cellSize   = {glob.cell_size}")
        print(f"blockSize  = {glob.block_size}")
        print(f"nSamples   = {dset.n_samples}")
        print(f"entropy    = {args.entropy}")
        print(f"slotIndex  = {args.index}")
        print(f"nCells     = {dset.n_cells}")
        print(f"dataSource = {dset.data_src}")

    if args.circom is None and args.output is None:
        print("nothing to do!")
        print("use --help for getting a list of options")
        return 0

    if args.circom is not None:
        from .circom import write_circom_main_component

        print(f"writing circom main component into `{args.circom}`")
        write_circom_main_component(args.circom, glob, dset)

    if args.output is not None:
        print(f"writing proof input into `{args.output}`...")
        t0 = time.time()
        if args.field == "goldilocks":
            from ..oracle.goldilocks import int_to_digest
            from ..oracle.goldilocks_pipeline import (
                check_proof_input_gl,
                export_proof_input_gl,
                generate_proof_input_gl,
            )

            backend = args.backend
            if backend == "auto":
                backend = "device" if dset.n_slots * dset.n_cells >= 1 << 14 else "oracle"
                if args.verbose:
                    print(f"auto backend -> {backend}")
            if backend == "device":
                slot_bytes = glob.cell_size * dset.n_cells
                if (
                    slot_bytes >= (1 << 26)
                    and dset.n_cells > glob.block_size // glob.cell_size
                ):
                    from ..models.gl_proof_input import (
                        generate_proof_input_gl_streaming,
                    )

                    if args.verbose:
                        print(
                            f"device backend: streaming build ({slot_bytes >> 20} MB/slot)"
                        )
                    pi = generate_proof_input_gl_streaming(
                        args.hash, glob, dset, args.index, int_to_digest(args.entropy)
                    )
                else:
                    from ..models.gl_proof_input import generate_proof_input_gl_device

                    pi = generate_proof_input_gl_device(
                        args.hash, glob, dset, args.index, int_to_digest(args.entropy)
                    )
            elif backend == "native":
                from .. import native

                pi = native.generate_proof_input_gl_native(
                    args.hash, glob, dset, args.index, int_to_digest(args.entropy)
                )
            elif backend == "oracle":
                pi = generate_proof_input_gl(
                    args.hash, glob, dset, args.index, int_to_digest(args.entropy)
                )
            else:
                raise SystemExit(
                    f"backend `{backend}` is not available for goldilocks"
                )
            export_proof_input_gl(args.output, pi)
            if args.verbose:
                print(f"generated in {time.time() - t0:.3f}s")
            if args.check:
                check_proof_input_gl(args.hash, glob, pi)
                print("circuit semantics check: OK")
        else:
            pi = _generate(args.backend, glob, dset, args.index, args.entropy,
                           args.verbose)
            from .json_export import export_proof_input

            export_proof_input(args.output, pi)
            if args.verbose:
                print(f"generated in {time.time() - t0:.3f}s")
            if args.check:
                from ..models.circuit import check_circuit_semantics

                check_circuit_semantics(glob, dset, pi)
                print("circuit semantics check: OK")

    print("done")
    return 0


def _generate(backend: str, glob, dset, slot_index: int, entropy: int, verbose: bool):
    """Dispatch to a compute backend.  `auto` prefers device for large slots."""
    if backend == "auto":
        work = dset.n_slots * dset.n_cells
        backend = "device" if work >= 1 << 14 else "oracle"
        if verbose:
            print(f"auto backend -> {backend}")
    if backend == "oracle":
        from ..oracle.sampling import generate_proof_input

        return generate_proof_input(glob, dset, slot_index, entropy)
    if backend == "device":
        # large slots stream through the device in bounded-memory chunks;
        # small ones batch every slot's cells in one build
        slot_bytes = glob.cell_size * dset.n_cells
        if slot_bytes >= (1 << 26) and dset.n_cells > glob.block_size // glob.cell_size:
            from ..models.proof_input import generate_proof_input_streaming

            if verbose:
                print(f"device backend: streaming build ({slot_bytes >> 20} MB/slot)")
            return generate_proof_input_streaming(glob, dset, slot_index, entropy)
        from ..models.proof_input import generate_proof_input_device

        return generate_proof_input_device(glob, dset, slot_index, entropy)
    if backend == "native":
        from ..native import generate_proof_input_native

        return generate_proof_input_native(glob, dset, slot_index, entropy)
    raise SystemExit(f"unknown backend {backend}")


if __name__ == "__main__":
    sys.exit(main())
