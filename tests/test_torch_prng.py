"""The port's ``jax.random`` slice (``repro_torch.core.prng``) against
``jax.random`` with the installed partitionable Threefry.

Key words (PRNGKey, split, fold_in, key_data) and uniforms are held
exact. Normals are held within 4 ulp: ``normal`` evaluates XLA's
``erf_inv`` polynomial, and the two libraries' ``log1p`` differ by an ulp
(measured: at most 3 ulp, on about 1 % of 2,000,000 draws; torch.erfinv
would be up to 64 ulp away).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1]
DATA = [0, 1, 7, 12345, 2 ** 31 - 1]
ULP = 4


def _words(a):
    return np.asarray(jax.random.key_data(a) if jnp.issubdtype(
        jnp.asarray(a).dtype, jax.dtypes.prng_key) else a).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_key_data(seed):
    kt = prng.PRNGKey(seed)
    assert kt.dtype == torch.int64 and tuple(kt.shape) == (2,)
    assert np.array_equal(prng.key_data(kt).numpy(),
                          _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_exact(seed, num):
    got = prng.split(prng.PRNGKey(seed), num).numpy()
    assert np.array_equal(got, _words(jax.random.split(
        jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_exact(seed, data):
    got = prng.fold_in(prng.PRNGKey(seed), data).numpy()
    assert np.array_equal(got, _words(jax.random.fold_in(
        jax.random.PRNGKey(seed), data)))


def test_fold_in_vectorised_over_rows():
    ids = np.arange(3, 1003, dtype=np.int64)
    kj = jax.random.PRNGKey(9)
    want = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        kj, jnp.asarray(ids, jnp.int32))
    got = prng.fold_in(prng.PRNGKey(9), torch.from_numpy(ids))
    assert np.array_equal(got.numpy(), _words(want))


def test_key_chain_of_a_fit():
    """The solver's chain: one split an iteration, the subkey used."""
    kj, kt = jax.random.PRNGKey(0), prng.PRNGKey(0)
    for _ in range(5):
        kj, sj = jax.random.split(kj)
        kt, st = prng.split(kt)
        assert np.array_equal(st.numpy(), _words(sj))
    assert np.array_equal(kt.numpy(), _words(kj))


@pytest.mark.parametrize("shape", [(), (1,), (1000,), (7, 3)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_exact(seed, shape):
    got = prng.uniform(prng.PRNGKey(seed), shape)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulp(seed):
    got = prng.normal(prng.PRNGKey(seed), (100_000,))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (100_000,)))
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= ULP


def test_normal_of_batched_keys():
    """Per-row keys with shape () draws, as augment.draw_ig_noise uses."""
    ids = np.arange(500, dtype=np.int64)
    kj = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(4), jnp.asarray(ids, jnp.int32))
    want = jax.vmap(lambda k: jax.random.normal(k, ()))(kj)
    kt = prng.fold_in(prng.PRNGKey(4), torch.from_numpy(ids))
    got = prng.normal(kt)
    assert tuple(got.shape) == (500,)
    assert _ulps(got.numpy(), want).max() <= ULP
    want_u = jax.vmap(lambda k: jax.random.uniform(k, ()))(kj)
    assert np.array_equal(prng.uniform(kt).numpy(), np.asarray(want_u))


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erf_inv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[1])
    assert _ulps(got[2:], want[2:]).max() <= ULP


@pytest.mark.parametrize("row0", [0, 4099])
def test_host_noise_and_rowwise_oracle(row0):
    """rng='host' noise (augment.draw_ig_noise: a fold_in a row, then
    split, then normal / uniform) and the gamma_mc_rowwise oracle built on
    it: uniforms exact, normals within 4 ulp, and gamma within 1e-3
    relative on at least 99.95 % of rows (a normal one ulp off moves
    gamma by a few ulp; near the hinge knee the transform amplifies it)."""
    from repro.core import augment as jaug
    from repro_torch.core import augment as taug
    n = 20_000
    kj = jax.random.fold_in(jax.random.PRNGKey(6), 1)
    kt = prng.fold_in(prng.PRNGKey(6), 1)
    nu_j, u_j = jaug.draw_ig_noise(kj, n, row0)
    nu_t, u_t = taug.draw_ig_noise(kt, n, row0)
    assert np.array_equal(u_t.numpy(), np.asarray(u_j))
    assert _ulps(nu_t.numpy(), nu_j).max() <= ULP
    res = (0.5 * np.random.default_rng(0).normal(size=n)).astype(np.float32)
    g_j = np.asarray(jaug.gamma_mc_rowwise(kj, jnp.asarray(res), 1e-6, row0),
                     np.float64)
    g_t = taug.gamma_mc_rowwise(kt, torch.from_numpy(res), 1e-6,
                                row0).numpy()
    assert np.all(np.isfinite(g_t)) and np.all(g_t >= np.float32(1e-6))
    assert np.mean(np.abs(g_t - g_j) <= 1e-3 * g_j) >= 0.9995
