"""Jitted end-to-end pipelines (L3-L6): slot trees, dataset trees, sampling,
proof-input generation, and circuit-semantics evaluation on a JAX device.

These compose the ops/ kernels into the pipelines the reference implements
host-side in Nim/Haskell (reference/nim/proof_input/src/gen_input/bn254.nim,
reference/haskell/src/Sampling.hs), re-designed as batched device programs.
"""
