#!/bin/bash
# Paths for the proving workflow (reference workflow/paths.sh).
#
# CIRCUIT_ROOT must point at a checkout of the upstream circom circuits
# (codex-storage-proofs-circuits/circuit); this framework generates the
# main component and the proof input, the circuits themselves remain the
# interop target.  Defaults probe the usual locations.

ORIG=$(pwd)

: "${CSPC_CLI:=cspc-tpu}"
: "${CIRCUIT_ROOT:=}"
if [[ -z "$CIRCUIT_ROOT" ]]; then
  for cand in "${ORIG}/../codex-storage-proofs-circuits/circuit" \
              "/root/reference/circuit"; do
    if [[ -d "$cand" ]]; then CIRCUIT_ROOT="$cand"; break; fi
  done
fi

CIRCUIT_PRF_DIR="${CIRCUIT_ROOT}/codex"
CIRCUIT_POS_DIR="${CIRCUIT_ROOT}/poseidon2"
CIRCUIT_LIB_DIR="${CIRCUIT_ROOT}/lib"

: "${PTAU_PATH:=${ORIG}/../ceremony/powersOfTau28_hez_final_21.ptau}"

CIRCUIT_MAIN="proof_main"
BUILD_DIR="${ORIG}/build"
