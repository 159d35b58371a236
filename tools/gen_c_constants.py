"""Emit the BN254/Poseidon2 protocol constants as a C header.

Writes codex_storage_proofs_circuits_tpu/native/poseidon2_constants.h from
fields/bn254.py (the same constants the circuit inlines,
reference circuit/poseidon2/poseidon2_perm.circom:27-136).  Limbs are 4x
uint64 little-endian, values in Montgomery form (R = 2^256).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from codex_storage_proofs_circuits_tpu.fields import bn254  # noqa: E402


def limbs4(x: int) -> str:
    ls = [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]
    return "{" + ", ".join(f"0x{v:016x}ULL" for v in ls) + "}"


def main() -> None:
    out = os.path.join(
        os.path.dirname(__file__), "..",
        "codex_storage_proofs_circuits_tpu", "native", "poseidon2_constants.h",
    )
    P = bn254.P
    lines = [
        "/* generated by tools/gen_c_constants.py — do not edit */",
        "#pragma once",
        "#include <stdint.h>",
        '/* storage of the tables: plain C by default; the CUDA build puts them in',
        ' * __constant__ memory (ops/cuda/lanes.h) */',
        '#ifndef CSPC_CONST',
        '#define CSPC_CONST static const',
        '#endif',
        "",
        f"CSPC_CONST uint64_t FR_P[4] = {limbs4(P)};",
        f"CSPC_CONST uint64_t FR_P_INV_NEG = 0x{(-pow(P, -1, 1 << 64)) % (1 << 64):016x}ULL; /* -P^-1 mod 2^64 */",
        f"CSPC_CONST uint64_t FR_R_MONT[4] = {limbs4(bn254.R_MONT)};",
        f"CSPC_CONST uint64_t FR_R2_MONT[4] = {limbs4(bn254.R2_MONT)};",
        "",
        "/* round constants, Montgomery form */",
        "CSPC_CONST uint64_t P2_EXT_RC[8][3][4] = {",
    ]
    for triple in bn254.EXTERNAL_ROUND_CONSTS:
        lines.append(
            "  {" + ", ".join(limbs4(bn254.to_mont(c)) for c in triple) + "},"
        )
    lines.append("};")
    lines.append("CSPC_CONST uint64_t P2_INT_RC[56][4] = {")
    for c in bn254.INTERNAL_ROUND_CONSTS:
        lines.append(f"  {limbs4(bn254.to_mont(c))},")
    lines.append("};")
    lines.append("")
    lines.append("/* Montgomery forms of the Merkle keys 0..3 and sponge IVs */")
    lines.append("CSPC_CONST uint64_t P2_KEYS[4][4] = {")
    for k in range(4):
        lines.append(f"  {limbs4(bn254.to_mont(k))},")
    lines.append("};")
    lines.append(
        f"CSPC_CONST uint64_t P2_SPONGE1_IV[4] = {limbs4(bn254.to_mont((1 << 64) + 0x0301))};"
    )
    lines.append(
        f"CSPC_CONST uint64_t P2_SPONGE2_IV[4] = {limbs4(bn254.to_mont((1 << 64) + 0x0302))};"
    )
    lines.append(f"CSPC_CONST uint64_t P2_ONE_MONT[4] = {limbs4(bn254.to_mont(1))};")
    lines.append("")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
