"""The port's exact-Gram kernel SVM (KRN-{EM,MC}-CLS, paper Sec 3.1, Table 7)
against the JAX package's, on the CPU.

The dual weights are not compared: the near-singular lam*K + S solve
amplifies any reordering of the sums to O(1) in omega (the reference's own
tests/test_distributed.py says so). So exact KRN is held on the decision
values f = K omega, on accuracy, and on the first iteration's
``gamma_mean`` (margins are exactly 0 at omega = 0, so MC draws the same
gamma from the same keys).

Exact: ``pad_gram`` (blockdiag(K, I)). ``kernel_reg`` within rtol 1e-6.
``posterior_params(prior_precision=)`` on a well-conditioned SPD prior
(A A^T / n + I): L and mu within 1e-5 relative.

One ``krn_step`` from omega = 0 on make_circles(400), sigma 0.7, lam 0.1:
EM f = K omega within 1e-3 relative, ``gamma_mean`` and the objective
within rtol 1e-5; MC the first ``gamma_mean`` within rtol 1e-5. Past
FUSED_STATS_MAX_K (N = 1,540, padded to 1,544) the statistic takes the
fused_estep + syrk_tri route, and the mask reaches syrk_tri's weights:
the padded rows and columns of Sigma are exactly 0, Sigma within 1e-5
max|S| of the reference's, and one EM step's f within 1e-3.

The default jitter's limit, shared with the reference: on
make_circles(8,192) (sigma 0.7, lam_from_C(1.0) = 2) the first EM step
at the default jitter 1e-4 is NaN in both packages (the float32 P =
lam*K + S does not factor at that ridge), and at jitter 1e-3 both are
finite and f agrees within 1e-3 relative.

Whole fits (make_circles(400), sigma 0.7, lam 0.1, 40 iterations), EM
and MC: score >= 0.97 and within 0.01 of the reference's; EM |d n_iters|
<= 3 and the training decision values within 5e-2 relative.

On a gloo mesh (four CPU ranks, N = 320, which both layouts pad alike):
the MC fit's first ``gamma_mean`` within rtol 1e-5 of one device (the
chain does not depend on the layout), EM's score within 0.01 of one
device, on 4 x 1 and on 2 x 2 with a ``k_shard_axis`` (which the exact
solver leaves out of its data axes, as the reference does).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PEMSVM as JaxSVM
from repro.core import SVMConfig as JaxConfig
from repro.core import kernel as jkrn
from repro.core import linear as jlin
from repro.core import objective as jobj
from repro.core import stats as jstats
from repro.kernels import ops as jops
from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
from repro_torch.core import kernel as tkrn
from repro_torch.core import objective as tobj
from repro_torch.core import prng
from repro_torch.core import stats as tstats
from repro_torch.core.convert import config_from_reference, svm_from_reference
from repro_torch.core.linear import SVMData
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from test_torch_kshard import _rel, run_ranks


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _T(a):
    return torch.from_numpy(np.array(a))


def _gram(X, sigma=0.7):
    return np.asarray(jkrn.gram_matrix(jnp.asarray(X), jnp.asarray(X),
                                       sigma=sigma, backend="ref"))


# ------------------------------------------------------------- exact
@pytest.mark.parametrize("n_pad", [0, 1, 5])
def test_pad_gram_bitwise(n_pad):
    G = np.random.default_rng(n_pad).normal(size=(11, 11)).astype(np.float32)
    ref = np.asarray(jkrn.pad_gram(jnp.asarray(G), n_pad))
    assert np.array_equal(tkrn.pad_gram(_T(G), n_pad).numpy(), ref)


def test_kernel_reg():
    g = np.random.default_rng(1)
    om = g.normal(size=57).astype(np.float32)
    Ko = g.normal(size=57).astype(np.float32)
    np.testing.assert_allclose(float(tobj.kernel_reg(_T(om), _T(Ko), 0.3)),
                               float(jobj.kernel_reg(om, Ko, 0.3)),
                               rtol=1e-6)


def test_posterior_params_with_a_prior_precision():
    g = np.random.default_rng(2)
    n = 48
    A = g.normal(size=(n, n))
    prior = (A @ A.T / n + np.eye(n)).astype(np.float32)
    B = g.normal(size=(3 * n, n)).astype(np.float32)
    S = (B.T @ B).astype(np.float32)
    b = g.normal(size=n).astype(np.float32)
    L_r, mu_r = jstats.posterior_params(jnp.asarray(S), jnp.asarray(b), 0.7,
                                        prior_precision=jnp.asarray(prior),
                                        jitter=1e-4)
    L, mu = tstats.posterior_params(_T(S), _T(b), 0.7,
                                    prior_precision=_T(prior), jitter=1e-4)
    assert _rel(L.numpy(), L_r) <= 1e-5
    assert _rel(mu.numpy(), mu_r) <= 1e-5


# ------------------------------------------------------------ one step
def _step_pair(mode, X, y, n_pad=0):
    N = X.shape[0]
    G = np.asarray(jkrn.pad_gram(jnp.asarray(_gram(X)), n_pad))
    t = np.concatenate([y, np.zeros(n_pad, np.float32)])
    mask = np.concatenate([np.ones(N), np.zeros(n_pad)]).astype(np.float32)
    kw = dict(mode=mode, lam=0.1, jitter=1e-4)
    om_r, aux_r = jkrn.krn_step(
        jlin.SVMData(jnp.asarray(G), jnp.asarray(t), jnp.asarray(mask)),
        jnp.asarray(G), jnp.zeros(G.shape[0]), jax.random.PRNGKey(3),
        backend="ref", **kw)
    om, aux = tkrn.krn_step(
        SVMData(_T(G), _T(t), _T(mask)), _T(G), torch.zeros(G.shape[0]),
        prng.PRNGKey(3) if mode == "MC" else None, **kw)
    return G, (np.asarray(om_r), aux_r), (om.numpy(), aux)


@pytest.mark.parametrize("mode", ["EM", "MC"])
def test_one_step_from_zero(mode):
    X, y = tsyn.make_circles(400)
    G, (om_r, aux_r), (om, aux) = _step_pair(mode, X, y)
    assert set(aux) == {"objective", "gamma_mean"}
    np.testing.assert_allclose(float(aux["gamma_mean"]),
                               float(aux_r["gamma_mean"]), rtol=1e-5)
    if mode == "EM":
        assert _rel(G @ om, G @ om_r) <= 1e-3
        np.testing.assert_allclose(float(aux["objective"]),
                                   float(aux_r["objective"]), rtol=1e-5)


def test_split_route_masks_the_padding():
    """N = 1,540 rows padded to 1,544 > FUSED_STATS_MAX_K: fused_estep +
    syrk_tri, with the mask as syrk_tri's weights."""
    X, y = tsyn.make_circles(1540, seed=4)
    n_pad = 4
    G, (om_r, _), (om, aux) = _step_pair("EM", X, y, n_pad)
    assert G.shape[0] > tops.FUSED_STATS_MAX_K
    assert _rel(G @ om, G @ om_r) <= 1e-3
    t = np.concatenate([y, np.zeros(n_pad, np.float32)])
    mask = np.concatenate([np.ones(1540), np.zeros(n_pad)]).astype(
        np.float32)
    w = np.zeros(G.shape[0], np.float32)
    S = tops.fused_stats(_T(G), _T(t), _T(t), _T(w), _T(mask))[-1].numpy()
    S_r = np.asarray(jops.fused_stats(
        jnp.asarray(G), jnp.asarray(t), jnp.asarray(t), jnp.asarray(w),
        jnp.asarray(mask), backend="ref")[-1])
    assert not np.any(S[1540:]) and not np.any(S[:, 1540:])
    assert np.max(np.abs(S - S_r)) <= 1e-5 * np.max(np.abs(S_r))


@pytest.mark.parametrize("jitter", [1e-4, 1e-3])
def test_default_jitter_fails_like_the_reference(jitter):
    N = 8192
    X, y = tsyn.make_circles(N)
    G = _gram(X)
    mask = np.ones(N, np.float32)
    kw = dict(mode="EM", lam=2.0, jitter=jitter)
    om_r, aux_r = jkrn.krn_step(
        jlin.SVMData(jnp.asarray(G), jnp.asarray(y), jnp.asarray(mask)),
        jnp.asarray(G), jnp.zeros(N), jax.random.PRNGKey(0), backend="ref",
        **kw)
    om, aux = tkrn.krn_step(SVMData(_T(G), _T(y), _T(mask)), _T(G),
                            torch.zeros(N), **kw)
    finite = (np.isfinite(float(aux_r["objective"])),
              np.isfinite(float(aux["objective"])))
    assert finite == ((False, False) if jitter == 1e-4 else (True, True))
    if jitter == 1e-3:
        assert _rel(G @ om.numpy(), G @ np.asarray(om_r)) <= 1e-3


# ---------------------------------------------------------- whole fits
def _cfg(cls, algo, **kw):
    return cls(formulation="KRN", algorithm=algo, lam=0.1, sigma=0.7,
               max_iters=40, **kw)


@pytest.fixture(scope="module")
def fits():
    X, y = tsyn.make_circles(400)
    out = {"X": X, "y": y}
    for algo in ("EM", "MC"):
        ref = JaxSVM(_cfg(JaxConfig, algo))
        port = PEMSVM(_cfg(SVMConfig, algo), device="cpu")
        out[algo] = (ref, ref.fit(X, y), port, port.fit(X, y))
    return out


@pytest.mark.parametrize("algo", ["EM", "MC"])
def test_whole_fit_scores(fits, algo):
    ref, r, port, p = fits[algo]
    X, y = fits["X"], fits["y"]
    assert p.weights.shape == (400,)
    assert set(p.aux_history) == {"objective", "gamma_mean"}
    assert port.score(X, y) >= 0.97
    assert abs(port.score(X, y) - ref.score(X, y)) <= 0.01
    pred = port.predict(X)
    assert set(np.unique(pred).tolist()) <= {-1, 1}


def test_em_fit_iterations_and_decision_values(fits):
    ref, r, port, p = fits["EM"]
    X = fits["X"]
    assert r.converged and p.converged
    assert abs(r.n_iters - p.n_iters) <= 3, (r.n_iters, p.n_iters)
    f_ref = np.asarray(ref.decision_function(X))
    assert _rel(port.decision_function(X), f_ref) <= 5e-2


def test_mc_first_gamma_mean(fits):
    _, r, _, p = fits["MC"]
    np.testing.assert_allclose(p.aux_history["gamma_mean"][0],
                               r.aux_history["gamma_mean"][0], rtol=1e-5)


# --------------------------------------------------------- conversion
def test_reference_krn_weights_predict_in_the_port():
    """A reference KRN fit's omega, with its training rows, predicts in
    the port as in the reference: labels equal, margins within 1e-5 of
    max|ref|."""
    X, y = tsyn.make_circles(300, seed=2)
    ref = JaxSVM(_cfg(JaxConfig, "EM"))
    r = ref.fit(X, y)
    port = svm_from_reference(config_from_reference(
        dataclasses.asdict(ref.config)), r.weights, 2, device="cpu",
        train_X=np.asarray(ref._train_X))
    Xt, _ = tsyn.make_circles(200, seed=5)
    f_ref = np.asarray(ref.decision_function(Xt))
    f = port.decision_function(Xt)
    assert np.max(np.abs(f - f_ref)) <= 1e-5 * np.max(np.abs(f_ref))
    assert np.array_equal(port.predict(Xt), np.asarray(ref.predict(Xt)))
    with pytest.raises(ValueError, match="training rows"):
        svm_from_reference(SVMConfig(formulation="KRN"), r.weights, 2,
                           device="cpu")


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw,err,match", [
    (dict(algorithm="MC", rng="fused"), ValueError, "NystromSVM"),
    (dict(algorithm="MC", rng="fused_predraw"), ValueError, "NystromSVM"),
    (dict(task="SVR"), NotImplementedError, "NystromSVM"),
    (dict(task="MLT", num_classes=3), NotImplementedError, "NystromSVM"),
    (dict(driver="stream"), NotImplementedError, "NystromSVM"),
])
def test_exact_krn_refusals(kw, err, match):
    with pytest.raises(err, match=match):
        PEMSVM(SVMConfig(formulation="KRN", **kw), device="cpu")


def test_runs_on_the_card_by_default():
    """``PEMSVM(SVMConfig.from_options("KRN-EM-CLS", sigma=0.7))`` and
    ``NystromSVM(... "KRN-EM-MLT" ...)`` pick cuda:0; without a card they
    say so instead of falling back."""
    for make in (lambda: PEMSVM(SVMConfig.from_options("KRN-EM-CLS",
                                                       sigma=0.7)),
                 lambda: NystromSVM(SVMConfig.from_options(
                     "KRN-EM-MLT", num_classes=10))):
        if torch.cuda.is_available():
            svm = make()
            assert getattr(svm, "svm", svm).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


# ---------------------------------------------------------------- mesh
_MESH_CODE = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=240))
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.core import PEMSVM, SVMConfig
d = np.load(out + "/inputs.npz")
X, y = d["X"], d["y"]
meshes = {"4x1": (DeviceMesh("cpu", torch.arange(4),
                             mesh_dim_names=("data",)), None),
          "2x2": (DeviceMesh("cpu", torch.arange(4).view(2, 2),
                             mesh_dim_names=("data", "k")), "k")}
res = {}
base = dict(formulation="KRN", lam=0.1, sigma=0.7)
for name, (mesh, k) in meshes.items():
    mc = SVMConfig(algorithm="MC", burnin=0, max_iters=1, min_iters=1,
                   k_shard_axis=k, **base)
    em = SVMConfig(max_iters=40, k_shard_axis=k, **base)
    r = PEMSVM(mc, device="cpu", mesh=mesh).fit(X, y)
    res[name + "_mc_gamma"] = r.aux_history["gamma_mean"][0]
    res[name + "_mc_obj"] = r.objective[0]
    svm = PEMSVM(em, device="cpu", mesh=mesh)
    r = svm.fit(X, y)
    res[name + "_em_score"] = svm.score(X, y)
    res[name + "_em_f"] = svm.decision_function(X)
    res[name + "_em_w"] = r.weights
if rank == 0:
    r = PEMSVM(SVMConfig(algorithm="MC", burnin=0, max_iters=1, min_iters=1,
                         **base), device="cpu").fit(X, y)
    res["one_mc_gamma"] = r.aux_history["gamma_mean"][0]
    res["one_mc_obj"] = r.objective[0]
    svm = PEMSVM(SVMConfig(max_iters=40, **base), device="cpu")
    svm.fit(X, y)
    res["one_em_score"] = svm.score(X, y)
    res["one_em_f"] = svm.decision_function(X)
np.savez(f"{out}/rank{rank}.npz", **{k: np.asarray(v) for k, v in
                                     res.items()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """The reference's layout-invariance problem
    (tests/test_distributed.py): N = 320 rings."""
    rng = np.random.default_rng(0)
    N = 320
    r_ = np.concatenate([rng.uniform(0, 1, N // 2),
                         rng.uniform(1.5, 2.5, N // 2)])
    th = rng.uniform(0, 2 * np.pi, N)
    X = np.stack([r_ * np.cos(th), r_ * np.sin(th)], 1).astype(np.float32)
    y = np.concatenate([np.ones(N // 2), -np.ones(N // 2)]).astype(
        np.float32)
    d = tmp_path_factory.mktemp("krn_mesh")
    np.savez(d / "inputs.npz", X=X, y=y)
    return run_ranks(_MESH_CODE, d)


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_mesh_mc_chain_is_layout_invariant(mesh, layout):
    one = mesh[0]
    for r in mesh:
        np.testing.assert_allclose(r[layout + "_mc_gamma"],
                                   one["one_mc_gamma"], rtol=1e-5)
        np.testing.assert_allclose(r[layout + "_mc_obj"],
                                   one["one_mc_obj"], rtol=1e-4)


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_mesh_em_score_and_ranks(mesh, layout):
    one = mesh[0]
    for r in mesh:
        assert np.array_equal(r[layout + "_em_w"], one[layout + "_em_w"])
        assert abs(float(r[layout + "_em_score"])
                   - float(one["one_em_score"])) <= 0.01
    assert float(one["one_em_score"]) > 0.97
    assert _rel(one[layout + "_em_f"], one["one_em_f"]) <= 5e-2
