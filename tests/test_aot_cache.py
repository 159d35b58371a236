"""AOT executable cache (utils/cache.py aot_call).

The streaming pipeline's chunk programs are large to trace and lower;
aot_call serializes the compiled executable so later processes skip
tracing, lowering AND compilation.  These tests cover the cache contract on the CPU backend:
roundtrip correctness, on-disk reuse, the code-fingerprint key term (a code
change must never hit a stale executable), and graceful fallback.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from codex_storage_proofs_circuits_tpu.utils import cache


@functools.partial(jax.jit, static_argnames=("n",))
def _poly(x, n):
    for _ in range(n):
        x = x * 3 + 1
    return x


@pytest.fixture
def aot_env(tmp_path, monkeypatch):
    monkeypatch.setenv("CSPC_AOT", "1")
    monkeypatch.setattr(cache, "_AOT_MEM", {})
    monkeypatch.setattr(cache, "AOT_STATS", cache.collections.Counter())
    return str(tmp_path / "aot")


def test_roundtrip_and_disk_reuse(aot_env):
    x = jnp.arange(16, dtype=jnp.uint32).reshape(2, 8)
    want = np.asarray(_poly(x, 3))
    got = cache.aot_call(_poly, "poly", (x,), (3,), base=aot_env)
    np.testing.assert_array_equal(np.asarray(got), want)
    files = os.listdir(aot_env)
    assert any(f.endswith(".jaxexec") for f in files)
    assert cache.AOT_STATS == {"compiled": 1}
    # fresh in-memory state: the second call must load from disk
    cache._AOT_MEM.clear()
    got2 = cache.aot_call(_poly, "poly", (x,), (3,), base=aot_env)
    np.testing.assert_array_equal(np.asarray(got2), want)
    assert cache.AOT_STATS == {"compiled": 1, "loaded": 1}


def test_key_includes_code_fingerprint(monkeypatch):
    x = jnp.zeros((2, 8), jnp.uint32)
    k1 = cache._aot_key("poly", "cpu", (x,), (3,))
    monkeypatch.setattr(cache, "_CODE_FP", "different-code-version")
    k2 = cache._aot_key("poly", "cpu", (x,), (3,))
    assert k1 != k2, "code change must invalidate the AOT key"


def test_key_varies_with_shapes_and_statics():
    a = jnp.zeros((2, 8), jnp.uint32)
    b = jnp.zeros((4, 8), jnp.uint32)
    assert cache._aot_key("n", "cpu", (a,), (3,)) != cache._aot_key(
        "n", "cpu", (b,), (3,)
    )
    assert cache._aot_key("n", "cpu", (a,), (3,)) != cache._aot_key(
        "n", "cpu", (a,), (4,)
    )


def test_disabled_env_bypasses(tmp_path, monkeypatch):
    monkeypatch.setenv("CSPC_AOT", "0")
    x = jnp.ones((2, 8), jnp.uint32)
    got = cache.aot_call(_poly, "poly", (x,), (2,), base=str(tmp_path / "off"))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(_poly(x, 2)))
    assert not os.path.exists(str(tmp_path / "off"))


def test_corrupt_cache_entry_falls_back(aot_env):
    x = jnp.arange(8, dtype=jnp.uint32).reshape(1, 8)
    cache.aot_call(_poly, "poly", (x,), (5,), base=aot_env)
    for f in os.listdir(aot_env):
        with open(os.path.join(aot_env, f), "wb") as fh:
            fh.write(b"garbage")
    cache._AOT_MEM.clear()
    got = cache.aot_call(_poly, "poly", (x,), (5,), base=aot_env)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(_poly(x, 5)))


def test_code_fingerprint_stable_and_hex():
    fp1 = cache._code_fingerprint()
    fp2 = cache._code_fingerprint()
    assert fp1 == fp2
    int(fp1, 16)
    assert len(fp1) == 16


def test_key_includes_runtime_versions_and_routes(monkeypatch):
    x = jnp.zeros((2, 8), jnp.uint32)
    names = [n for n, _ in cache._runtime_versions()]
    assert "jax" in names and "jaxlib" in names
    k1 = cache._aot_key("poly", "cpu", (x,), (3,))
    monkeypatch.setattr(cache, "_VERSIONS", [("jaxlib", "0.0.0")])
    assert cache._aot_key("poly", "cpu", (x,), (3,)) != k1
    monkeypatch.setattr(cache, "_VERSIONS", None)
    from codex_storage_proofs_circuits_tpu.ops import routes

    monkeypatch.setattr(routes, "_override", {"prng": "triton"})
    assert cache._aot_key("poly", "cpu", (x,), (3,)) != k1


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_cache_dir_env_or_fixed_checkout_path(tmp_path, monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.cache_dir() == os.path.join(repo, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
        assert cache.cache_dir() == str(tmp_path / env_dir)
