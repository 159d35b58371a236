"""Bit-exact pure-Python CPU oracle (L1-L4).

This is the judge for every accelerated kernel: the device (ops/, models/) and
native (native/) paths must reproduce these outputs exactly.  Semantics follow
the reference implementations:

  poseidon2.py  reference/haskell/src/Poseidon2/{Permutation,Sponge}.hs
  merkle.py     reference/haskell/src/Poseidon2/Merkle.hs,
                reference/nim/proof_input/src/merkle{,.bn254}.nim
  slot.py       reference/haskell/src/Slot.hs, reference/nim/.../slot.nim
  dataset.py    reference/haskell/src/DataSet.hs, reference/nim/.../dataset.nim
  sampling.py   reference/haskell/src/Sampling.hs, reference/nim/.../sample/
"""

from .poseidon2 import (
    permutation,
    compression,
    keyed_compression,
    sponge1,
    sponge2,
)
from .merkle import MerkleTree, MerkleProof, merkle_tree, merkle_root
from .slot import gen_fake_cell, hash_cell_bytes, cell_data_to_field_elements
