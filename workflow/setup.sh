#!/bin/bash
# Circuit compile + Groth16 setup (reference workflow/setup.sh:11-38).
#
# Every external stage degrades gracefully: missing tools are reported and
# skipped, so the script is usable both on a full proving host (circom +
# snarkjs installed) and on a bare device host (main-component emission only).
set -e
MY_DIR=$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )
source "${MY_DIR}/paths.sh"
source "${MY_DIR}/cli_args.sh"

mkdir -p "$BUILD_DIR"
cd "$BUILD_DIR"

# --- generate the main component (our CLI, mirrors reference cli.nim:186-204)
$CSPC_CLI $CLI_ARGS -v --circom="${CIRCUIT_MAIN}.circom"

# --- compile the circuit ---
if ! command -v circom >/dev/null; then
  echo "[skip] circom not installed; stopping after main-component emission"
  echo "       (install circom + snarkjs and re-run for the full setup)"
  exit 0
fi
if [[ ! -d "$CIRCUIT_LIB_DIR" ]]; then
  echo "[skip] upstream circuit sources not found (set CIRCUIT_ROOT)"
  exit 0
fi
start=$(date +%s)
CIRCUIT_INCLUDES="-l${CIRCUIT_LIB_DIR} -l${CIRCUIT_POS_DIR} -l${CIRCUIT_PRF_DIR}"
circom --r1cs --wasm --O2 ${CIRCUIT_INCLUDES} "${CIRCUIT_MAIN}.circom"
echo "circom compile: $(($(date +%s) - start))s"

# --- circuit-specific Groth16 setup ---
if ! command -v snarkjs >/dev/null; then
  echo "[skip] snarkjs not installed; stopping after circuit compile"
  exit 0
fi
if [[ ! -f "$PTAU_PATH" ]]; then
  echo "[skip] powers-of-tau file not found at $PTAU_PATH"
  exit 0
fi
start=$(date +%s)
NODE_OPTIONS="--max-old-space-size=8192" \
  snarkjs groth16 setup "${CIRCUIT_MAIN}.r1cs" "$PTAU_PATH" "${CIRCUIT_MAIN}_0000.zkey"
echo "some_entropy_75289v3b7rcawcsyiur" | \
NODE_OPTIONS="--max-old-space-size=8192" \
  snarkjs zkey contribute "${CIRCUIT_MAIN}_0000.zkey" "${CIRCUIT_MAIN}_0001.zkey" \
  --name="1st Contributor"
rm "${CIRCUIT_MAIN}_0000.zkey"
mv "${CIRCUIT_MAIN}_0001.zkey" "${CIRCUIT_MAIN}.zkey"
snarkjs zkey export verificationkey "${CIRCUIT_MAIN}.zkey" \
  "${CIRCUIT_MAIN}_verification_key.json"
echo "groth16 setup: $(($(date +%s) - start))s"
