"""Compile caches: JAX's persistent compilation cache and an on-disk cache of
compiled executables.

Both live in one directory: JAX_COMPILATION_CACHE_DIR when it is set, else
`.jax_cache/` at the root of the checkout (a fixed path, so a later process
finds what an earlier one stored).  Executables go to its `aot/`
subdirectory.
"""

from __future__ import annotations

import collections
import hashlib
import os

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at cache_dir() and cache
    every compiled program.  Does nothing (returns None) where the cache is
    switched off (JAX_ENABLE_COMPILATION_CACHE=false, as in the tests)."""
    import jax

    if not jax.config.jax_enable_compilation_cache:
        return None
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


# ---------------------------------------------------------------------------
# AOT executable cache.  The persistent compilation cache (above) skips XLA
# *backend* compilation, but jax still traces and lowers the program in
# every process.  Serializing the *compiled* executable
# (jax.experimental.serialize_executable) skips tracing, lowering and
# compilation on reload; the cache key pins everything the executable
# depends on (jax, jaxlib and plugin versions, backend, device kind, kernel
# routes, package sources, arg shapes, statics).

_AOT_MEM: dict = {}
_CODE_FP: str | None = None
_VERSIONS: list | None = None

# "loaded": executable read from disk; "compiled": compiled and stored;
# "unserializable": compiled but the backend cannot serialize it (kept in
# memory only, so the next process compiles again)
AOT_STATS: collections.Counter = collections.Counter()


def _code_fingerprint() -> str:
    """Digest of the package's own source tree.  The serialized executable
    embeds code compiled from these files; without this term in the key, a
    code change to a cached function would silently deserialize the OLD
    executable and return stale results (unlike the HLO-keyed persistent
    compile cache, which re-keys automatically)."""
    global _CODE_FP
    if _CODE_FP is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "build"))
            for fn in sorted(filenames):
                if fn.endswith((".py", ".c", ".h", ".cu")):
                    p = os.path.join(dirpath, fn)
                    h.update(os.path.relpath(p, root).encode())
                    with open(p, "rb") as f:
                        h.update(f.read())
        _CODE_FP = h.hexdigest()[:16]
    return _CODE_FP


def _runtime_versions() -> list:
    """Versions of jax, jaxlib and any installed jax plugin (CUDA)."""
    global _VERSIONS
    if _VERSIONS is None:
        import importlib.metadata as md

        found = set()
        for d in md.distributions():
            name = (d.metadata["Name"] or "").lower().replace("_", "-")
            if name in ("jax", "jaxlib") or name.startswith("jax-cuda"):
                found.add((name, d.version))
        _VERSIONS = sorted(found)
    return _VERSIONS


def _aot_key(name: str, backend, args, statics) -> str:
    import jax

    from ..ops import routes

    dev = jax.devices()[0]
    # CSPC_* env vars (e.g. CSPC_GL_CONSTANTS) can change what is traced
    env_knobs = sorted(
        (k, v) for k, v in os.environ.items() if k.startswith("CSPC_")
    )
    sig = repr(
        (
            _runtime_versions(),
            backend,
            getattr(dev, "device_kind", "?"),
            sorted(routes.describe().items()),
            _code_fingerprint(),
            env_knobs,
            name,
            statics,
            [(tuple(a.shape), str(a.dtype)) for a in args],
        )
    )
    return hashlib.sha256(sig.encode()).hexdigest()[:24]


def aot_call(jitted, name: str, args: tuple, statics: tuple = (), base: str | None = None):
    """Call `jitted(*args, *statics)` through an on-disk compiled-executable
    cache under `base` (default: cache_dir()/aot).  Disable with CSPC_AOT=0.
    AOT_STATS counts how each executable was obtained."""
    import jax

    if os.environ.get("CSPC_AOT", "1") == "0":
        return jitted(*args, *statics)
    from ..ops import routes

    if "cuda" in routes.describe().values():
        from ..ops import cuda_ffi

        cuda_ffi.library()  # FFI targets must exist before an executable loads
    backend = jax.default_backend()
    key = _aot_key(name, backend, args, statics)
    compiled = _AOT_MEM.get(key)
    if compiled is None:
        import pickle

        from jax.experimental.serialize_executable import (
            deserialize_and_load,
            serialize,
        )

        path = os.path.join(base or os.path.join(cache_dir(), "aot"), key + ".jaxexec")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    payload, in_tree, out_tree = pickle.load(f)
                # single-device programs: run on the default device, not
                # on every device of the backend
                compiled = deserialize_and_load(
                    payload, in_tree, out_tree, execution_devices=jax.devices()[:1]
                )
                AOT_STATS["loaded"] += 1
            except Exception:
                os.unlink(path)  # stale or unreadable: recompile below
        if compiled is None:
            compiled = jitted.lower(*args, *statics).compile()
            try:
                blob = pickle.dumps(serialize(compiled))
            except Exception:
                AOT_STATS["unserializable"] += 1
            else:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
                AOT_STATS["compiled"] += 1
        _AOT_MEM[key] = compiled
    return compiled(*args)
