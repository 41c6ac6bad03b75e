"""The port's counter RNG (``repro_torch.kernels.rng``) against
``repro.kernels.rng``, and the ``seed_noise`` layout of the plain kernel
version against ``repro.kernels.ref.seed_noise``.

Threefry words, ``pack_seed`` and uniforms are held exact, including
counter and key wrap-around. Box-Muller normals are held within 4 ulp:
the two libraries' ``log`` and ``cos`` differ by an ulp (measured: at most
3 ulp, on about 11 % of rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import rng as jrng
from repro_torch.core import prng
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rng as trng

ULP = 4
U32 = 2 ** 32


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("k0,k1", [(0, 0), (0x12345678, 0xFFFFFFFF),
                                   (U32 - 1, U32 - 1), (42, 2 ** 31)])
def test_threefry_words_exact(k0, k1):
    g = np.random.default_rng(0)
    c0 = np.concatenate([[0, 1, U32 - 1, 2 ** 31, 2 ** 31 - 1],
                         g.integers(0, U32, 995)]).astype(np.uint32)
    c1 = np.concatenate([[U32 - 1, 0, U32 - 1, 5, 2 ** 32 - 2],
                         g.integers(0, U32, 995)]).astype(np.uint32)
    want = jrng.threefry2x32(np.uint32(k0), np.uint32(k1), jnp.asarray(c0),
                             jnp.asarray(c1))
    got = trng.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                            torch.from_numpy(c1.astype(np.int64)))
    for a, b in zip(got, want):
        assert a.dtype == torch.int64
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))


def test_uniform_from_bits_exact():
    bits = np.random.default_rng(1).integers(0, U32, 100_000,
                                             dtype=np.uint32)
    bits[:4] = [0, 1, U32 - 1, 2 ** 31]
    got = trng.uniform_from_bits(torch.from_numpy(bits.astype(np.int64)))
    want = np.asarray(jrng.uniform_from_bits(jnp.asarray(bits)))
    assert np.array_equal(got.numpy(), want)
    assert 0.0 < got.min() and got.max() < 1.0


def test_normal_from_bits_within_4_ulp():
    g = np.random.default_rng(2)
    b0, b1 = (g.integers(0, U32, 200_000, dtype=np.uint32)
              for _ in range(2))
    got = trng.normal_from_bits(torch.from_numpy(b0.astype(np.int64)),
                                torch.from_numpy(b1.astype(np.int64)))
    want = jrng.normal_from_bits(jnp.asarray(b0), jnp.asarray(b1))
    assert _ulps(got.numpy(), want).max() <= ULP


@pytest.mark.parametrize("row0,chain0", [(0, 0), (7, 3), (2 ** 31 - 5, 1)])
def test_pack_seed_exact(row0, chain0):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jrng.pack_seed(key, row0, chain0)).astype(np.int64)
    got = trng.pack_seed(prng.fold_in(prng.PRNGKey(3), 11), row0, chain0)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_noise", [2, 4])
def test_draw_fused_noise(n_noise):
    want = jrng.draw_fused_noise(jax.random.PRNGKey(5), 50_000, 13, 2,
                                 n_noise)
    got = trng.draw_fused_noise(prng.PRNGKey(5), 50_000, 13, 2, n_noise)
    for m in range(n_noise // 2):
        assert _ulps(got[2 * m].numpy(), want[2 * m]).max() <= ULP
        assert np.array_equal(got[2 * m + 1].numpy(),
                              np.asarray(want[2 * m + 1]))


@pytest.mark.parametrize("n_chains", [1, 3])
def test_seed_noise_layout(n_chains):
    key = jax.random.PRNGKey(8)
    jseed = jrng.pack_seed(key, 21, 2)
    tseed = trng.pack_seed(prng.PRNGKey(8), 21, 2)
    want = jref.seed_noise(jseed, 301, n_chains, "mc_hinge")
    got = tref.seed_noise(tseed, 301, n_chains, "mc_hinge")
    shape = (301, n_chains) if n_chains > 1 else (301,)
    assert tuple(got[0].shape) == tuple(got[1].shape) == shape
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert _ulps(got[0].numpy(), want[0]).max() <= ULP
    # chain c of the (n, C) layout is the single-chain stream at chain0+c
    if n_chains > 1:
        one = tref.seed_noise(trng.pack_seed(prng.PRNGKey(8), 21, 3), 301,
                              1, "mc_hinge")
        assert torch.equal(got[0][:, 1], one[0])
        assert torch.equal(got[1][:, 1], one[1])


def test_fused_noise_tile_offset():
    """A tile starting at operand row r0 gets the stream of rows
    seed[2] + r0 + i, as the reference's in-body tile noise."""
    from repro_torch.kernels import epilogues as tepi
    seed = trng.pack_seed(prng.PRNGKey(2), 5, 1)
    tile = tepi.fused_noise(seed, 64, (32, 2), "mc_hinge")
    full = tref.seed_noise(seed, 96, 2, "mc_hinge")
    assert torch.equal(tile[0], full[0][64:])
    assert torch.equal(tile[1], full[1][64:])
