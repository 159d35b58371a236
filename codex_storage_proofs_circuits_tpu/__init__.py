"""codex_storage_proofs_circuits_tpu — a storage-proof primitive library in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
codex-storage/codex-storage-proofs-circuits reference system:

  * BN254 scalar-field (Fr) arithmetic as multi-limb integer kernels
  * batched Poseidon2 t=3 permutation / compression / sponges
  * cell -> block(depth-5) -> slot -> dataset Merkle tree construction
  * storage-proof sampling and circuit proof-input generation
  * witness generation / constraint evaluation for the sampling circuit

Layer map (mirrors reference SURVEY.md section 1, re-designed for batched
device execution):

  fields/    L0  field constants + scalar reference arithmetic
  oracle/    L1-L4 bit-exact pure-Python CPU oracle (the judge for kernels)
  ops/       L1-L2 batched kernels: jnp limb planes, a Pallas-Triton PRNG,
             CUDA hash kernels (ops/routes.py picks per backend)
  models/    L3-L6 jitted pipelines: slot trees, dataset trees, sampling,
             proof inputs, circuit semantics evaluation
  parallel/  multi-chip sharding: mesh, shard_map tree builds, collectives
  utils/     config, CLI, JSON export, circom main-component writer, metrics
  native/    C host library: fast bit-exact CPU path (fake-data PRNG,
             Fr Montgomery arithmetic, Poseidon2) for large-scale parity checks
"""

__version__ = "0.1.0"
