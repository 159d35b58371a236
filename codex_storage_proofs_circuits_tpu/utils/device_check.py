"""Device checks of the kernel routes: frozen vectors and plain-path parity.

`frozen_vectors` runs the frozen vector suites (tests/vectors/*.json) through
whatever routes ops/routes.py picks, each case broadcast over `width`
lanes, so every lane of a production-width call must reproduce the frozen
value.  `kernels_vs_plain` feeds random inputs of `width` lanes to every
kernel route and to the plain jnp path and requires equal outputs.  All
values are integers, so both compare exactly; no float product is on this
path, so no TF32 or matmul precision setting can enter.

chip_smoke.py runs both on the card at the 8192-lane chunk width; the CPU
tests run them at a small width through the kernels' interpret mode and
host build.
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import routes

VECTORS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests",
    "vectors",
)

# frozen cases run through the device (the suites' other cases run on the
# oracle in the CPU tests): every padding boundary of the byte and felt
# encodings, odd/even/singleton tree shapes
BN_SPONGE_N = range(1, 9)
BN_BYTES_N = (0, 1, 30, 31, 32, 61, 62, 80)
GL_DIGEST_N = range(0, 18)
GL_BYTES_N = (0, 1, 61, 62, 63, 123, 124, 130)
MERKLE_N = (1, 2, 3, 5, 8, 13, 31, 40)


def _planes(values, nl: int, width: int) -> np.ndarray:
    """ints -> (len, nl, width) uint32 16-bit limb planes, broadcast on lanes."""
    out = np.zeros((len(values), nl, width), np.uint32)
    for i, v in enumerate(values):
        for l in range(nl):
            out[i, l, :] = (v >> (16 * l)) & 0xFFFF
    return out


def _ints(planes: np.ndarray) -> list[int]:
    """(nl, width) -> one int per lane."""
    nl, w = planes.shape
    return [sum(int(planes[l, b]) << (16 * l) for l in range(nl)) for b in range(w)]


def _digests(planes: np.ndarray) -> list[tuple]:
    """(4, 4, width) -> one digest tuple per lane."""
    per = [_ints(planes[j]) for j in range(4)]
    return [tuple(p[b] for p in per) for b in range(planes.shape[2])]


def _bytes_rows(n: int, width: int) -> np.ndarray:
    """(width, n) uint8: the byte string 1, 2, ..., n (mod 256) in every lane."""
    row = np.array([(i % 256) for i in range(1, n + 1)], np.uint8)
    return np.broadcast_to(row, (width, n)).copy()


def _all_equal(got: list, want, what: str) -> None:
    bad = [i for i, g in enumerate(got) if g != want]
    if bad:
        raise AssertionError(
            f"{what}: {len(bad)} of {len(got)} lanes differ (first lane {bad[0]})"
        )


def frozen_vectors(width: int) -> int:
    """Check the frozen suites through the current routes; returns the
    number of (case, lane) values compared."""
    from ..models import gl_hashing as GH
    from ..models import hashing as H
    from ..ops.encode import encode_cells_device
    from ..ops.gl_encode import encode_cells_gl_device
    from ..oracle.goldilocks import int_to_digest
    from ..parallel.gl_tree import gl_tree_reduce_general

    with open(os.path.join(VECTORS_DIR, "bn254_testvectors.json")) as f:
        bn = json.load(f)
    with open(os.path.join(VECTORS_DIR, "gl_testvectors.json")) as f:
        gl = json.load(f)
    checked = 0

    bn_hash = jax.jit(lambda f: H.from_mont(H.hash_cells_mont(f)))
    for n in BN_SPONGE_N:
        got = _ints(np.asarray(bn_hash(_planes(range(1, n + 1), 16, width))))
        _all_equal(got, int(bn["sponge_rate2_felts"][n]), f"bn254 sponge2 n={n}")
        checked += width
    bn_cells = jax.jit(lambda c: H.from_mont(H.hash_cells_mont(encode_cells_device(c))))
    for n in BN_BYTES_N:
        got = _ints(np.asarray(bn_cells(_bytes_rows(n, width))))
        _all_equal(got, int(bn["hash_bytes"][n]), f"bn254 hash_bytes n={n}")
        checked += width
    for n in MERKLE_N:
        leaves = H.to_mont(jnp.asarray(_planes(range(1, n + 1), 16, 1)[:, :, 0].T))
        root = _ints(np.asarray(H.from_mont(H.tree_reduce_general(leaves)[-1])))
        _all_equal(root, int(bn["merkle_felts"][n - 1]), f"bn254 merkle n={n}")
        checked += 1

    for hf in ("poseidon2", "monolith"):
        want = gl[hf]
        sponge = jax.jit(lambda f, hf=hf: GH.sponge_digests(hf, f))
        for n in GL_DIGEST_N:
            got = _digests(np.asarray(sponge(_planes(range(1, n + 1), 4, width))))
            _all_equal(got, tuple(int(v) for v in want["digest_felts"][n]),
                       f"{hf} digest_felts n={n}")
            checked += width
        cells = jax.jit(
            lambda r, hf=hf: GH.sponge_digests(hf, encode_cells_gl_device(r, r.shape[0]))
        )
        for n in GL_BYTES_N:
            got = _digests(np.asarray(cells(_bytes_rows(n, width).T)))
            _all_equal(got, tuple(int(v) for v in want["digest_bytes"][n]),
                       f"{hf} digest_bytes n={n}")
            checked += width
        for n in MERKLE_N:
            leaves = np.stack(
                [_planes(int_to_digest(k), 4, 1)[:, :, 0] for k in range(1, n + 1)],
                axis=2,
            )  # (4, 4, n)
            root = _digests(np.asarray(gl_tree_reduce_general(jnp.asarray(leaves), hf)[-1]))
            _all_equal(root, tuple(int(v) for v in want["merkle_felts"][n - 1]),
                       f"{hf} merkle n={n}")
            checked += 1
    return checked


def _random_planes(rng, shape, top_mask: int) -> np.ndarray:
    """Random 16-bit limb planes (limb axis -2) with the top limb masked
    below the field modulus."""
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., -1, :] &= top_mask
    return x


def kernels_vs_plain(width: int, seed: int = 0, n_steps: int = 2048) -> list[str]:
    """Every kernel route against the plain jnp path on random inputs of
    `width` lanes; returns the names of the operations compared."""
    from ..models import gl_hashing as GH
    from ..models import hashing as H
    from ..ops import fake_prng as F

    rng = np.random.default_rng(seed)
    bn_state = _random_planes(rng, (3, 16, width), 0x2FFF)  # < P
    bn_felts = _random_planes(rng, (67, 16, width), 0x00FF)  # 31-byte felts
    gl_felts = _random_planes(rng, (272, 4, width), 0x3FFF)  # 62-bit felts
    gl_x = _random_planes(rng, (4, 4, width), 0x7FFF)  # < p
    gl_y = _random_planes(rng, (4, 4, width), 0x7FFF)
    s1, s2 = F.fake_seed_planes(seed, 0, width)

    ops = {
        "bn254": {
            "bn254 permute": lambda: H.permute(jnp.asarray(bn_state)),
            "bn254 cell sponge": lambda: H.hash_cells_mont(jnp.asarray(bn_felts)),
            "bn254 to_mont": lambda: H.to_mont(jnp.asarray(bn_state[0])),
            "bn254 from_mont": lambda: H.from_mont(jnp.asarray(bn_state[0])),
        },
        "gl": {
            f"{hf} {op}": fn
            for hf in ("poseidon2", "monolith")
            for op, fn in (
                ("cell sponge", lambda hf=hf: GH.sponge_digests(hf, jnp.asarray(gl_felts))),
                ("compress", lambda hf=hf: GH.compress_digests(
                    hf, 1, jnp.asarray(gl_x), jnp.asarray(gl_y))),
            )
        },
        "prng": {"fake prng": lambda: F.gen_rows(s1, s2, n_steps)},
    }
    compared = []
    for fam, fam_ops in ops.items():
        if routes.route(fam) == "jnp":
            continue
        got = {name: np.asarray(fn()) for name, fn in fam_ops.items()}
        with routes.use(**{fam: "jnp"}):
            for name, fn in fam_ops.items():
                want = np.asarray(fn())
                bad = np.argwhere(got[name] != want)
                if len(bad):
                    raise AssertionError(f"{name}: {len(bad)} values differ from plain jnp")
                compared.append(name)
    return compared
