"""Emit the Goldilocks hash-instance constants as a C header.

Writes codex_storage_proofs_circuits_tpu/native/gl_constants.h from
fields/goldilocks.py (same tables as the oracle and the device kernels).
Values are plain uint64 residues (< p) — Goldilocks needs no Montgomery
form in the C path (native u128 products).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from codex_storage_proofs_circuits_tpu.fields import goldilocks as G  # noqa: E402
from codex_storage_proofs_circuits_tpu.oracle.goldilocks import SPONGE_IV_GL  # noqa: E402


def main() -> None:
    out = os.path.join(
        os.path.dirname(__file__), "..",
        "codex_storage_proofs_circuits_tpu", "native", "gl_constants.h",
    )
    lines = [
        "/* generated by tools/gen_gl_c_constants.py — do not edit */",
        "#pragma once",
        "#include <stdint.h>",
        '/* storage of the tables: plain C by default; the CUDA build puts them in',
        ' * __constant__ memory (ops/cuda/lanes.h) */',
        '#ifndef CSPC_CONST',
        '#define CSPC_CONST static const',
        '#endif',
        "",
        f"#define GL_P 0x{G.P_GL:016x}ULL",
        f"#define GL_SPONGE_IV 0x{SPONGE_IV_GL:016x}ULL",
        f"#define GL_RF {G.RF}",
        f"#define GL_RP {G.RP}",
        f"#define GL_T {G.T}",
        f"#define GL_RATE {G.RATE}",
        f"#define GL_MONO_ROUNDS {G.MONOLITH_ROUNDS}",
        f"#define GL_MONO_BARS {G.MONOLITH_BARS}",
        "",
        "CSPC_CONST uint64_t GL_EXT_RC[GL_RF][GL_T] = {",
    ]
    for row in G.P2GL_EXTERNAL_RC:
        lines.append("  {" + ", ".join(f"0x{v:016x}ULL" for v in row) + "},")
    lines.append("};")
    lines.append("")
    lines.append("CSPC_CONST uint64_t GL_INT_RC[GL_RP] = {")
    lines.append("  " + ", ".join(f"0x{v:016x}ULL" for v in G.P2GL_INTERNAL_RC))
    lines.append("};")
    lines.append("")
    lines.append("CSPC_CONST uint64_t GL_DIAG_M1[GL_T] = {")
    lines.append(
        "  "
        + ", ".join(f"0x{(v - 1) % G.P_GL:016x}ULL" for v in G.P2GL_INTERNAL_DIAG)
    )
    lines.append("};")
    lines.append("")
    lines.append("CSPC_CONST uint64_t GL_MONO_RC[GL_MONO_ROUNDS][GL_T] = {")
    for row in G.MONOLITH_RC:
        lines.append("  {" + ", ".join(f"0x{v:016x}ULL" for v in row) + "},")
    lines.append("};")
    lines.append("")
    lines.append("/* Monolith Concrete (Plonky2-compatible MDS) full matrix */")
    lines.append("CSPC_CONST uint64_t GL_MONO_CONCRETE[GL_T][GL_T] = {")
    for row in G.MONOLITH_CONCRETE:
        lines.append("  {" + ", ".join(f"{v}ULL" for v in row) + "},")
    lines.append("};")
    lines.append("")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
