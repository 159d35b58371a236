#!/usr/bin/env python
"""Print the cross-implementation test-vector suites as diffable text.

Twin of the reference's vector programs, which print identical suites from
Nim and Haskell with a `NIM |` / line prefix so implementations can be
compared with plain `diff` (reference/nim/testvectors/src/testvectors.nim:20-72
== reference/haskell/src/TestVectors.hs:28-75).  This prints the same lines
with a `JAX |` prefix in the reference's exact format:

    diff <(./testvectors | sed 's/^NIM /X /') \
         <(python tools/print_testvectors.py | sed 's/^JAX /X /')

shows only the header-prefix lines when the implementations agree.  (The
frozen JSON suites under tests/vectors/ hold the same values; this tool is
the *textual* interface the reference designed for.)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from codex_storage_proofs_circuits_tpu.oracle.merkle import merkle_root
from codex_storage_proofs_circuits_tpu.oracle.poseidon2 import sponge1, sponge2
from codex_storage_proofs_circuits_tpu.oracle.slot import (
    cell_data_to_field_elements,
    hash_cell_bytes,
)


def main() -> int:
    out = sys.stdout

    # headers match testvectors.nim's text exactly (modulo the prefix)
    print("", file=out)
    print("JAX | test vectors for sponge of field elements with rate=1", file=out)
    print("-----------------------------------------------------------", file=out)
    for n in range(0, 9):
        h = sponge1([i for i in range(1, n + 1)])
        print(f"hash of [1..{n}] : seq[F] =  {h}", file=out)

    print("", file=out)
    print("JAX | test vectors for sponge of field elements with rate=2", file=out)
    print("-----------------------------------------------------------", file=out)
    for n in range(0, 9):
        h = sponge2([i for i in range(1, n + 1)])
        print(f"hash of [1..{n}] : seq[F] =  {h}", file=out)

    print("", file=out)
    print("JAX | test vectors for hash (padded sponge with rate=2) of bytes", file=out)
    print("----------------------------------------------------------------", file=out)
    for n in range(0, 81):
        h = hash_cell_bytes(bytes(range(1, n + 1)))
        print(f"hash of [1..{n}] : seq[byte] =  {h}", file=out)

    print("", file=out)
    print("JAX | test vectors for Merkle roots of field elements", file=out)
    print("-----------------------------------------------------", file=out)
    for n in range(1, 41):
        r = merkle_root([i for i in range(1, n + 1)])
        print(f"Merkle root of [1..{n}] : seq[F] =  {r}", file=out)

    print("", file=out)
    print("JAX | test vectors for Merkle roots of sequence of bytes", file=out)
    print("--------------------------------------------------------", file=out)
    for n in range(0, 81):
        felts = cell_data_to_field_elements(bytes(range(1, n + 1)))
        r = merkle_root(felts)
        print(f"Merkle root of [1..{n}] : seq[byte] =  {r}", file=out)

    return 0


if __name__ == "__main__":
    sys.exit(main())
