#!/bin/bash
# Proof-input -> witness -> proof -> verify (reference workflow/prove.sh:13-87).
#
# The proof input is generated by the device pipeline; witness generation and
# proving dispatch to whatever external tools are installed.  When none are,
# the script still validates the generated input end-to-end against the
# framework's own witness-level circuit evaluator (--check), which re-derives
# every circuit `===` assertion — the device-side replacement for a dry-run
# witness generation.
set -e
MY_DIR=$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )
source "${MY_DIR}/paths.sh"
source "${MY_DIR}/cli_args.sh"

mkdir -p "$BUILD_DIR"
cd "$BUILD_DIR"

# --- generate the proof input (device pipeline) + self-check ---
echo "generating the proof input..."
$CSPC_CLI $CLI_ARGS -v --output=input.json --check

# --- generate the witness ---
if [[ -d "${CIRCUIT_MAIN}_js" ]] && command -v node >/dev/null; then
  start=$(date +%s)
  ( cd "${CIRCUIT_MAIN}_js" && \
    node generate_witness.js "${CIRCUIT_MAIN}.wasm" ../input.json ../witness.wtns )
  echo "witness generation: $(($(date +%s) - start))s"
else
  echo "[skip] WASM witness generator not available (run setup.sh with circom"
  echo "       installed); input.json was validated by the built-in evaluator"
  exit 0
fi

# --- create the proof ---
PROVER=""
for cand in rapidsnark snarkjs; do
  if command -v $cand >/dev/null; then PROVER=$cand; break; fi
done
if [[ -z "$PROVER" ]]; then
  echo "[skip] no Groth16 prover installed (snarkjs/rapidsnark)"
  exit 0
fi
echo "creating the proof with $PROVER..."
start=$(date +%s)
case $PROVER in
  snarkjs)    snarkjs groth16 prove "${CIRCUIT_MAIN}.zkey" witness.wtns proof.json public.json ;;
  rapidsnark) rapidsnark "${CIRCUIT_MAIN}.zkey" witness.wtns proof.json public.json ;;
esac
echo "prove: $(($(date +%s) - start))s"

# --- verify + solidity verifier ---
if command -v snarkjs >/dev/null; then
  snarkjs groth16 verify "${CIRCUIT_MAIN}_verification_key.json" public.json proof.json
  snarkjs zkey export solidityverifier "${CIRCUIT_MAIN}.zkey" verifier.sol
fi
