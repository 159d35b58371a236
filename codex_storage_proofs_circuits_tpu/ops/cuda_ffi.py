"""CUDA kernels for the BN254 and Goldilocks hash families, via jax.ffi.

One thread hashes one lane with its whole state in registers: a cell's
sponge runs every permutation of the cell without touching device memory
in between, where the plain path writes the state back after each one.
The arithmetic is in cuda/lanes.h, the XLA FFI handlers in
cuda/kernels.cu.

The library is compiled at first use from the sources in this package,
into cuda/build/ (named by a digest of the sources, so an edit rebuilds):
with nvcc for sm_90a on a GPU, and with the host C++ compiler on any other
backend, where each handler loops over its lanes.  The host build lets the
CPU tests run the kernels' arithmetic and these wrappers.  Override the
compilers with NVCC and CXX.

Inputs and outputs keep the plain path's layout: uint32 planes of 16-bit
limbs, lanes on the last axis; BN254 permutation states in Montgomery form.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import jax
import jax.numpy as jnp

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "cuda")
NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
BUILD_DIR = os.path.join(SRC_DIR, "build")
_SOURCES = (
    os.path.join(SRC_DIR, "kernels.cu"),
    os.path.join(SRC_DIR, "lanes.h"),
    os.path.join(NATIVE_DIR, "poseidon2_constants.h"),
    os.path.join(NATIVE_DIR, "gl_constants.h"),
)
# FFI target name -> handler symbol in kernels.cu
TARGETS = {
    "cspc_bn254_permute": "CspcBnPermute",
    "cspc_bn254_sponge": "CspcBnSponge",
    "cspc_bn254_mont": "CspcBnMont",
    "cspc_gl_sponge": "CspcGlSponge",
    "cspc_gl_compress": "CspcGlCompress",
}

_lock = threading.Lock()
_loaded: dict[str, str] = {}


def source_digest() -> str:
    h = hashlib.sha256()
    for p in _SOURCES:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _platform() -> str:
    return "cuda" if jax.default_backend() == "gpu" else "cpu"


def compile_command(platform: str, out: str) -> list[str]:
    src = _SOURCES[0]
    inc = ["-I", SRC_DIR, "-I", NATIVE_DIR, "-I", jax.ffi.include_dir()]
    if platform == "cuda":
        nvcc = (
            os.environ.get("NVCC")
            or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc"
        )
        return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", *inc, "-o", out, src]
    cxx = os.environ.get("CXX") or "c++"
    return [cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", *inc,
            "-o", out, src]


def library(platform: str | None = None) -> str:
    """Build (once per source digest) and register the kernel library for
    `platform` ("cuda" or "cpu"; default: the backend's); returns its path."""
    platform = platform or _platform()
    with _lock:
        if platform in _loaded:
            return _loaded[platform]
        path = os.path.join(BUILD_DIR, f"libcspc_{platform}_{source_digest()}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            r = subprocess.run(compile_command(platform, tmp), capture_output=True,
                               text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"building {os.path.basename(path)} failed:\n{r.stderr[-4000:]}"
                )
            os.replace(tmp, path)
        lib = ctypes.cdll.LoadLibrary(path)
        xla_platform = "CUDA" if platform == "cuda" else "cpu"
        for name, sym in TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, sym)), platform=xla_platform
            )
        _loaded[platform] = path
        return path


def _call(name: str, out_shape: tuple, *args, **attrs):
    library()
    return jax.ffi.ffi_call(
        name,
        jax.ShapeDtypeStruct(out_shape, jnp.uint32),
        vmap_method="sequential",
    )(*[jnp.asarray(a, jnp.uint32) for a in args],
      **{k: np.int64(v) for k, v in attrs.items()})


def bn254_permute(state):
    """(3, 16, B) Montgomery states -> permuted states."""
    assert state.ndim == 3 and state.shape[:2] == (3, 16), state.shape
    return _call("cspc_bn254_permute", state.shape, state)


def bn254_sponge(felts):
    """(nfelts, 16, B) canonical felts -> (16, B) Montgomery rate-2 sponge
    hashes (models/hashing.hash_cells_mont)."""
    nf, nl, b = felts.shape
    assert nl == 16
    return _call("cspc_bn254_sponge", (nl, b), felts)


def bn254_mont(x, to: bool):
    """(16, B) -> Montgomery form (to=True) or back to canonical."""
    assert x.ndim == 2 and x.shape[0] == 16, x.shape
    return _call("cspc_bn254_mont", x.shape, x, to=int(to))


def gl_sponge(hash_fun: str, felts):
    """(n, 4, B) felts -> (4, 4, B) rate-8 sponge digests."""
    n, nl, b = felts.shape
    assert nl == 4
    return _call("cspc_gl_sponge", (4, nl, b), felts,
                 monolith=hash_fun == "monolith")


def gl_compress(hash_fun: str, key: int, x, y):
    """Keyed compression of (4, 4, B) digest pairs."""
    assert x.shape == y.shape and x.shape[:2] == (4, 4), (x.shape, y.shape)
    return _call("cspc_gl_compress", x.shape, x, y, key=int(key),
                 monolith=hash_fun == "monolith")
