#!/bin/bash
# Circuit / dataset parameters, mirroring reference workflow/params.sh:3-14.
# Every value here is also a CI input (.github/workflows/ci.yml) and a CLI
# flag (codex_storage_proofs_circuits_tpu/utils/cli.py).

: "${MAXDEPTH:=32}"        # maximum depth of the slot tree
: "${MAXSLOTS:=256}"       # maximum number of slots
: "${CELLSIZE:=2048}"      # cell size in bytes
: "${BLOCKSIZE:=65536}"    # block size in bytes
: "${NSAMPLES:=5}"         # number of samples to prove

: "${ENTROPY:=1234567}"    # external randomness
: "${SEED:=12345}"         # seed for creating fake data

: "${NSLOTS:=11}"          # number of slots in the dataset
: "${SLOTINDEX:=3}"        # which slot we prove (0..NSLOTS-1)
: "${NCELLS:=512}"         # number of cells in this slot

: "${FIELD:=bn254}"        # bn254 | goldilocks
: "${HASH:=poseidon2}"     # poseidon2 | monolith
: "${BACKEND:=device}"     # oracle | device | native
