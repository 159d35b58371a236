"""The kernel routes off the GPU: the Triton PRNG kernel in interpret mode,
the CUDA kernels' host build (same source, a loop over lanes), the route
choice of ops/routes.py, and the wrappers' shapes and padding.

Each kernel is compared with the plain jnp path and with the oracle at a
few steps and a small lane count, so the file runs in seconds.  The same
checks at the card's 8192-lane chunk width are marked `gpu` and run there
(and in chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from codex_storage_proofs_circuits_tpu.fields import bn254
from codex_storage_proofs_circuits_tpu.models import hashing as H
from codex_storage_proofs_circuits_tpu.ops import cuda_ffi
from codex_storage_proofs_circuits_tpu.ops import fake_prng as F
from codex_storage_proofs_circuits_tpu.ops import goldilocks_jnp as GJ
from codex_storage_proofs_circuits_tpu.ops import limbs as L
from codex_storage_proofs_circuits_tpu.ops import poseidon2_jnp as P2
from codex_storage_proofs_circuits_tpu.ops import routes
from codex_storage_proofs_circuits_tpu.oracle import goldilocks as OG
from codex_storage_proofs_circuits_tpu.oracle.poseidon2 import permutation as oracle_perm
from codex_storage_proofs_circuits_tpu.oracle.slot import gen_fake_cell
from codex_storage_proofs_circuits_tpu.utils import device_check

KERNELS = dict(bn254="cuda", gl="cuda", prng="triton")


def _rand(shape, top, seed=0):
    x = np.random.default_rng(seed).integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., -1, :] &= top
    return x


# -- Triton PRNG (interpret mode) -------------------------------------------


@pytest.mark.parametrize("n_steps,B", [(64, 128), (30, 200)])
def test_prng_triton_matches_scan(n_steps, B):
    # (30, 200): steps not a multiple of 4 and lanes not a multiple of the
    # 128-lane block; both pad and slice back
    s1, s2 = F.fake_seed_planes(12345, 7, B)
    a = np.asarray(F._gen_scan(s1, s2, n_steps))
    b = np.asarray(F._gen_triton(s1, s2, n_steps, interpret=True))
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (n_steps, B)
    assert np.array_equal(a, b)


def test_prng_triton_matches_host_oracle():
    n_steps, B, seed, start = 48, 130, 424242, 11
    s1, s2 = F.fake_seed_planes(seed, start, B)
    rows = np.asarray(F._gen_triton(s1, s2, n_steps, interpret=True))
    for i in (0, 1, 127, 128, B - 1):  # both sides of the block boundary
        assert rows[:, i].tobytes() == gen_fake_cell(n_steps, seed, start + i)


def test_gen_rows_dispatch_fallback():
    # the plain route (the CPU default), bit-exact to the oracle
    s1, s2 = F.fake_seed_planes(5, 0, 96)
    rows = np.asarray(F.gen_rows(s1, s2, 32))
    assert rows[:, 0].tobytes() == gen_fake_cell(32, 5, 0)


def test_gen_rows_takes_the_triton_route_when_chosen(monkeypatch):
    calls = []
    monkeypatch.setattr(F, "_gen_triton", lambda *a, **k: calls.append(k) or "kernel")
    monkeypatch.setattr(routes, "_override", {"prng": "triton"})
    assert F.gen_rows(None, None, 8) == "kernel"
    assert calls == [{"interpret": True}]  # interpret mode off the GPU only


# -- route choice ------------------------------------------------------------


def test_routes_default_to_plain_off_the_gpu():
    assert jax.default_backend() == "cpu"
    assert routes.describe() == {"prng": "jnp", "bn254": "jnp", "gl": "jnp"}


def test_routes_use_overrides_and_restores():
    with routes.use(bn254="cuda"):
        assert routes.route("bn254") == "cuda" and routes.route("gl") == "jnp"
        with routes.use(gl="cuda"):
            assert routes.describe() == {"prng": "jnp", "bn254": "cuda", "gl": "cuda"}
        assert routes.route("gl") == "jnp"
    assert routes.describe() == {"prng": "jnp", "bn254": "jnp", "gl": "jnp"}


def test_routes_reject_unknown_names():
    with pytest.raises(ValueError):
        with routes.use(bn254="triton"):
            pass


def test_gpu_routes_name_every_family():
    assert set(routes.GPU_ROUTES) == set(routes.ROUTES)
    for fam, r in routes.GPU_ROUTES.items():
        assert r in routes.ROUTES[fam] and r != "jnp"


# -- CUDA kernels, host build --------------------------------------------------


@pytest.mark.parametrize("B", [1, 37, 129])
def test_bn254_permute_kernel(B):
    st = _rand((3, 16, B), 0x2FFF, seed=B)
    got = np.asarray(cuda_ffi.bn254_permute(jnp.asarray(st)))
    assert np.array_equal(got, np.asarray(jax.jit(P2.permutation)(jnp.asarray(st))))
    # lane 0 against the scalar oracle permutation
    vals = [L.unpack(st[k][:, :1])[0] for k in range(3)]
    want = oracle_perm(tuple(bn254.from_mont(v) for v in vals))
    assert tuple(bn254.from_mont(L.unpack(got[k][:, :1])[0]) for k in range(3)) == want


def test_bn254_sponge_kernel_matches_plain_path():
    f = _rand((9, 16, 21), 0x00FF, seed=1)
    got = np.asarray(cuda_ffi.bn254_sponge(jnp.asarray(f)))
    plain = jax.jit(lambda x: H.sponge2_scan(P2.pad_felts_rate2(H.to_mont_stack(x))))
    assert got.shape == (16, 21)
    assert np.array_equal(got, np.asarray(plain(jnp.asarray(f))))


@pytest.mark.parametrize("to", [True, False])
def test_bn254_mont_kernel(to):
    x = _rand((16, 33), 0x2FFF, seed=2)
    want = L.to_mont(jnp.asarray(x)) if to else L.from_mont(jnp.asarray(x))
    assert np.array_equal(np.asarray(cuda_ffi.bn254_mont(jnp.asarray(x), to)),
                          np.asarray(want))


@pytest.mark.parametrize("hf", ["poseidon2", "monolith"])
def test_gl_sponge_kernel(hf):
    g = _rand((17, 4, 13), 0x3FFF, seed=3)
    got = np.asarray(cuda_ffi.gl_sponge(hf, jnp.asarray(g)))
    assert np.array_equal(got, np.asarray(GJ.sponge_digest_felts(hf, jnp.asarray(g))))
    felts = [sum(int(g[i, l, 5]) << (16 * l) for l in range(4)) for i in range(17)]
    assert device_check._digests(got)[5] == OG.digest_felts(hf, felts)


@pytest.mark.parametrize("hf", ["poseidon2", "monolith"])
@pytest.mark.parametrize("key", [0, 3])
def test_gl_compress_kernel(hf, key):
    x, y = _rand((4, 4, 9), 0x7FFF, seed=4), _rand((4, 4, 9), 0x7FFF, seed=5)
    got = np.asarray(cuda_ffi.gl_compress(hf, key, jnp.asarray(x), jnp.asarray(y)))
    want = GJ.compress_batch(hf, key, jnp.asarray(x), jnp.asarray(y))
    assert np.array_equal(got, np.asarray(want))


def test_wrappers_reject_wrong_layouts():
    with pytest.raises(AssertionError):
        cuda_ffi.bn254_permute(jnp.zeros((2, 16, 4), jnp.uint32))
    with pytest.raises(AssertionError):
        cuda_ffi.bn254_mont(jnp.zeros((3, 16, 4), jnp.uint32), True)
    with pytest.raises(AssertionError):
        cuda_ffi.gl_compress("poseidon2", 0, jnp.zeros((4, 4, 3), jnp.uint32),
                             jnp.zeros((4, 4, 4), jnp.uint32))


def test_kernel_under_vmap_and_jit():
    # the sharded dataset build vmaps the per-slot body over local slots
    g = _rand((2, 9, 4, 6), 0x3FFF, seed=6)
    got = jax.jit(jax.vmap(lambda f: cuda_ffi.gl_sponge("poseidon2", f)))(jnp.asarray(g))
    for s in range(2):
        want = GJ.sponge_digest_felts("poseidon2", jnp.asarray(g[s]))
        assert np.array_equal(np.asarray(got[s]), np.asarray(want))


def test_compile_command_targets_hopper():
    cmd = cuda_ffi.compile_command("cuda", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1].endswith("kernels.cu")
    assert "-x" in cuda_ffi.compile_command("cpu", "out.so")


# -- the card's routes end to end ---------------------------------------------


def test_frozen_vectors_through_the_card_routes():
    with routes.use(**KERNELS):
        assert device_check.frozen_vectors(width=3) > 0


def test_every_kernel_matches_plain_path():
    with routes.use(**KERNELS):
        ops = device_check.kernels_vs_plain(width=3, n_steps=24)
    assert len(ops) == 9


@pytest.mark.parametrize("field", ["bn254", "goldilocks"])
def test_streaming_root_kernel_routes_match_plain(field):
    from codex_storage_proofs_circuits_tpu.models.streaming import (
        streaming_slot_root,
        streaming_slot_root_gl,
    )
    from codex_storage_proofs_circuits_tpu.oracle.slot import DataSource, SlotConfig

    cfg = SlotConfig(cell_size=64, block_size=256, n_cells=32, n_samples=1,
                     data_src=DataSource("fake", seed=9))
    build = (lambda: streaming_slot_root(cfg, chunk_cells=8)) if field == "bn254" \
        else (lambda: streaming_slot_root_gl(cfg, "monolith", chunk_cells=8))
    plain = build()
    with routes.use(**KERNELS):
        assert build() == plain


@pytest.mark.gpu
def test_gpu_kernels_at_chunk_width():
    assert routes.describe() == routes.GPU_ROUTES
    assert device_check.frozen_vectors(width=8192) > 0
    assert len(device_check.kernels_vs_plain(width=8192)) == 9
