"""Batched kernels (L1-L2): Fr limb arithmetic, Poseidon2, sponges.

Layout convention: a batch of field elements is a uint32 array of shape
(NUM_LIMBS, batch) — 16 little-endian 16-bit limb *planes* with the batch on
the minor axis, so elementwise limb ops vectorize across lanes.  Values are
kept canonical (< P, limbs < 2^16) in Montgomery form (radix 2^256) between
operations.

Two interchangeable implementations of each hot operation, chosen per
backend in one place (routes.py):
  poseidon2_jnp.py, goldilocks_jnp.py, fake_prng.py (scan)
                  pure jax.numpy: runs on any backend, the plain path
  cuda_ffi.py (+ cuda/), fake_prng.py (Triton kernel)
                  hand kernels for the GPU, bit-exact to the plain path
"""
