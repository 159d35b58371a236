"""The one place that picks the compute route of each kernel family.

Families:
  prng   fake-data byte recurrence (ops/fake_prng.py)
  bn254  Poseidon2 t=3 sponge, permutation, Montgomery conversion
         (models/hashing.py)
  gl     Goldilocks Poseidon2 t=12 and Monolith sponge and compression
         (models/gl_hashing.py)

Routes:
  jnp     plain jax.numpy, what XLA compiles for any backend
  triton  a Pallas kernel through Triton (interpret mode off the GPU)
  cuda    CUDA kernels through jax.ffi (ops/cuda_ffi.py; a host build of
          the same source off the GPU)

On a GPU each family takes its hand kernel; on any other backend the plain
path.  `use()` overrides routes by name: measurements compare a kernel with
the plain path on one card, and the CPU tests run the kernels' interpret
mode or host build.  Routes are read while a function is traced, so `use()`
drops JAX's caches of traced functions on entry and on exit.
"""

from __future__ import annotations

import contextlib

GPU_ROUTES = {"prng": "triton", "bn254": "cuda", "gl": "cuda"}
ROUTES = {"prng": ("jnp", "triton"), "bn254": ("jnp", "cuda"), "gl": ("jnp", "cuda")}

_override: dict[str, str] = {}


def on_gpu() -> bool:
    import jax

    return jax.default_backend() == "gpu"


def route(family: str) -> str:
    if family in _override:
        return _override[family]
    return GPU_ROUTES[family] if on_gpu() else "jnp"


def describe() -> dict[str, str]:
    """Route of every family, e.g. for a cache key or a report."""
    return {f: route(f) for f in GPU_ROUTES}


@contextlib.contextmanager
def use(**chosen: str):
    """Run the block with the named routes, e.g. `use(bn254="jnp")`."""
    import jax

    for fam, name in chosen.items():
        if name not in ROUTES[fam]:
            raise ValueError(f"route {name!r} is not one of {ROUTES[fam]} for {fam!r}")
    saved = dict(_override)
    _override.update(chosen)
    jax.clear_caches()
    try:
        yield
    finally:
        _override.clear()
        _override.update(saved)
        jax.clear_caches()
