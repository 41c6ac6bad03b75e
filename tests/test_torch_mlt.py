"""The port's Crammer-Singer multiclass SVM (LIN-{EM,MC}-MLT, paper Sec 3.3,
Table 8) against the JAX package's, on the CPU.

Exact: ``make_mnist8m_like`` (the Table 8 stand-in), ``_rho_beta`` for
every class y given the same score matrix, and the labels ``predict``
gives for the same W. ``cs_obj_terms`` within rtol 1e-6, masked and not.

One ``mlt_step`` from W = 0, against the reference's step evaluated
eagerly (the port is held to the reference's eager form: under ``jit`` the
reference's epilogue gammas differ from its own eager ones, ROADMAP section
3, and here its jitted MC step lands O(1) away from its eager step): EM W
within 1e-4 relative and the objective within rtol 1e-5; MC (rng 'host',
'fused_predraw', 'fused') W within 1e-3 relative, the CLS MC step band.
At W = 0 every row with y != y_d has residual 0, where the inverse-
Gaussian transform sits at its clamp and a one-ulp change of the normal nu
moves gamma by orders of magnitude. The counter modes' normals agree
across the packages only to a few ulp (``kernels/rng.py``; their words
are exact and held elsewhere), so for the counter modes the reference is
given the port's normal floats (``repro.kernels.rng.normal_from_bits``
patched for the call); keys, words, seed packing, the chain fold, the
transform, the solve and the draw are its own.

Whole fits on the reference's problem (tests/test_solvers.py: N 2,500,
K 20, M 5). EM (its 40 iterations, min 30), against the reference's loop
driver run eagerly: |d n_iters| <= 3, objective trace within 2e-2 and
accuracy within 0.01. The reference's jitted EM fit is no comparator: on
this problem its flat start (every row with y != y_d clamps gamma at eps
at W = 0) magnifies last-bit differences into a shift of the sweep where
the fit leaves its plateau. At 40 iterations the port's W sits at the
5e-2 band and moves with the BLAS summation order (the thread count), so
W is held within 5e-2 on a second pair of fits run past the descent (min
= max = 80 iterations), and the trajectory is also held step by step:
each of the port's 40 EM sweeps, from the port's own W, against the
reference's sweep from the same W: W within 1e-3 relative and the
objective within rtol 1e-3 (the CLS MC step band).

MC against the reference's fit with the same seed: both converge,
accuracy within 0.01, posterior-mean W within 0.15, on chains of 150-200
iterations after a burn-in of 50. At the reference test's 40 iterations
the chain is still leaving its flat start, and there the reference's own
posterior means for two seeds lie further apart than that band. The scan
driver is bitwise the loop driver within ceil(max_iters / scan_chunk) host
syncs.

Nystrom x MLT (tests/test_nystrom.py's problem, through
``fit_featurized`` with the reference's landmarks and projection): EM W
within 1e-3 relative, MC within 0.15; scores within 0.01.

On a gloo mesh (four CPU ranks): a 2 x 2 (data x k) EM and MC fit with
``k_shard_axis`` and ``pad_features`` (8 iterations): ranks bitwise equal,
within 5e-2 of the one-device fit; a one-rank mesh bitwise the fit
without a mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.rng as jrng
from repro.core import PEMSVM as JaxSVM
from repro.core import SVMConfig as JaxConfig
from repro.core import linear as jlin
from repro.core import multiclass as jmlt
from repro.core import objective as jobj
from repro.core.nystrom import NystromSVM as JaxNystrom
from repro.data import synthetic as jsyn
from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
from repro_torch.core import multiclass as tmlt
from repro_torch.core import objective as tobj
from repro_torch.core import prng
from repro_torch.core.convert import (config_from_reference,
                                      nystrom_from_reference,
                                      svm_from_reference)
from repro_torch.core.linear import SVMData
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import rng as trng
from test_torch_kshard import _rel, _trace_rel, run_ranks


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problem():
    """The reference's MLT problem (tests/test_solvers.py)."""
    rng = np.random.default_rng(5)
    N, K, M = 2500, 20, 5
    X = rng.normal(size=(N, K)).astype(np.float32)
    Wt = rng.normal(size=(M, K))
    labels = np.argmax(X @ Wt.T + 0.2 * rng.normal(size=(N, M)),
                       axis=1).astype(np.int32)
    return X, labels, M


def _T(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- exact
@pytest.mark.parametrize("n,k,m,seed", [(1000, 30, 10, 3), (257, 7, 4, 0),
                                        (64, 784, 10, 11)])
def test_make_mnist8m_like_bitwise(n, k, m, seed):
    Xr, lr = jsyn.make_mnist8m_like(n, k, m, seed=seed)
    Xp, lp = tsyn.make_mnist8m_like(n, k, m, seed=seed)
    assert Xp.dtype == Xr.dtype and lp.dtype == lr.dtype
    assert np.array_equal(Xp, Xr) and np.array_equal(lp, lr)


@pytest.mark.parametrize("y", range(5))
def test_rho_beta_bitwise(y):
    g = np.random.default_rng(2)
    F = g.normal(size=(301, 5)).astype(np.float32)
    labels = g.integers(0, 5, 301).astype(np.int32)
    rho_r, beta_r = jmlt._rho_beta(jnp.asarray(F), jnp.asarray(labels), y, 5)
    rho_p, beta_p = tmlt._rho_beta(_T(F), _T(labels), y, 5)
    assert np.array_equal(rho_p.numpy(), np.asarray(rho_r))
    assert np.array_equal(beta_p.numpy(), np.asarray(beta_r))


@pytest.mark.parametrize("masked", [False, True])
def test_cs_obj_terms(masked):
    g = np.random.default_rng(4)
    F = g.normal(size=(203, 6)).astype(np.float32)
    labels = g.integers(0, 6, 203).astype(np.int32)
    mask = ((g.random(203) > 0.3) if masked
            else np.ones(203)).astype(np.float32)
    np.testing.assert_allclose(
        float(tobj.cs_obj_terms(_T(F), _T(labels), _T(mask))),
        float(jobj.cs_obj_terms(F, labels, mask)), rtol=1e-6)


def test_predict_labels_bitwise():
    g = np.random.default_rng(6)
    W = g.normal(size=(7, 13)).astype(np.float32)
    X = g.normal(size=(400, 13)).astype(np.float32)
    ref = np.asarray(jmlt.predict(jnp.asarray(W), jnp.asarray(X)))
    assert np.array_equal(tmlt.predict(_T(W), _T(X)).numpy(), ref)


# ------------------------------------------------------------ one step
def _port_normal(b0, b1):
    """The port's counter normals, in the reference's array type."""
    z = trng.normal_from_bits(_T(np.asarray(b0).astype(np.int64)),
                              _T(np.asarray(b1).astype(np.int64)))
    return jnp.asarray(z.numpy())


@pytest.mark.parametrize("mode,rng", [("EM", "host"), ("MC", "host"),
                                      ("MC", "fused_predraw"),
                                      ("MC", "fused")])
def test_one_step_from_zero_matches_reference(mode, rng, monkeypatch):
    X, labels, M = _problem()
    Xb = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], 1)
    mask = np.ones(X.shape[0], np.float32)
    kw = dict(num_classes=M, mode=mode, lam=1.0, jitter=1e-7, rng=rng)
    if rng != "host":
        monkeypatch.setattr(jrng, "normal_from_bits", _port_normal)
    with jax.disable_jit():
        W_ref, aux_ref = jmlt.mlt_step(
            jlin.SVMData(jnp.asarray(Xb), jnp.asarray(labels),
                         jnp.asarray(mask)),
            jnp.zeros((M, Xb.shape[1])), jax.random.PRNGKey(7), **kw)
    W, aux = tmlt.mlt_step(
        SVMData(_T(Xb), _T(labels), _T(mask)), torch.zeros(M, Xb.shape[1]),
        prng.PRNGKey(7) if mode == "MC" else None, **kw)
    assert set(aux) == {"objective"}
    band = 1e-4 if mode == "EM" else 1e-3
    assert _rel(W.numpy(), W_ref) <= band
    if mode == "EM":
        np.testing.assert_allclose(float(aux["objective"]),
                                   float(aux_ref["objective"]), rtol=1e-5)


def test_fused_equals_fused_predraw_bitwise():
    """'fused_predraw' materializes the counter stream the 'fused' seed
    derives: the two MLT steps are bitwise equal, at any chain0."""
    X, labels, M = _problem()
    data = SVMData(_T(X[:600]), _T(labels[:600]), torch.ones(600))
    out = [tmlt.mlt_step(data, torch.zeros(M, 20), prng.PRNGKey(3),
                         num_classes=M, mode="MC", rng=r, chain0=2)
           for r in ("fused", "fused_predraw")]
    assert torch.equal(out[0][0], out[1][0])


# ---------------------------------------------------------- whole fits
def _mlt_cfg(cls, algo, long=False, **kw):
    _, _, M = _problem()
    iters = dict(max_iters=200, min_iters=150, burnin=50) if long else dict(
        max_iters=40 if algo == "EM" else 60, min_iters=30)
    return cls(algorithm=algo, task="MLT", num_classes=M, lam=1.0,
               **iters, **kw)


@pytest.fixture(scope="module")
def fits():
    X, labels, _ = _problem()
    out = {"X": X, "labels": labels}
    past = dict(max_iters=80, min_iters=80)
    with jax.disable_jit():
        ref = JaxSVM(_mlt_cfg(JaxConfig, "EM", driver="loop"))
        out["EM_ref"] = (ref, ref.fit(X, labels))
        out["EM_ref80"] = JaxSVM(dataclasses.replace(
            _mlt_cfg(JaxConfig, "EM", driver="loop"), **past)).fit(X, labels)
    out["EM_80"] = PEMSVM(dataclasses.replace(_mlt_cfg(SVMConfig, "EM"),
                                              **past),
                          device="cpu").fit(X, labels)
    ref = JaxSVM(_mlt_cfg(JaxConfig, "MC", long=True))
    out["MC_ref"] = (ref, ref.fit(X, labels))
    port = PEMSVM(_mlt_cfg(SVMConfig, "MC", long=True), device="cpu")
    out["MC_long"] = (port, port.fit(X, labels))
    for algo in ("EM", "MC"):
        for driver in ("scan", "loop"):
            port = PEMSVM(_mlt_cfg(SVMConfig, algo, driver=driver),
                          device="cpu")
            out[f"{algo}_{driver}"] = (port, port.fit(X, labels))
    return out


def test_em_sweeps_match_the_reference_from_the_same_state():
    X, labels, M = _problem()
    Xb = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], 1)
    mask = np.ones(X.shape[0], np.float32)
    ref_data = jlin.SVMData(jnp.asarray(Xb), jnp.asarray(labels),
                            jnp.asarray(mask))
    data = SVMData(_T(Xb), _T(labels), _T(mask))
    kw = dict(num_classes=M, mode="EM", lam=1.0, jitter=1e-7)
    W = torch.zeros(M, Xb.shape[1])
    for it in range(40):
        W_new, aux = tmlt.mlt_step(data, W, None, **kw)
        W_ref, aux_ref = jmlt.mlt_step(ref_data, jnp.asarray(W.numpy()),
                                       jax.random.PRNGKey(0), **kw)
        assert _rel(W_new.numpy(), W_ref) <= 1e-3, it
        np.testing.assert_allclose(float(aux["objective"]),
                                   float(aux_ref["objective"]), rtol=1e-3)
        W = W_new


def test_em_fit_bands(fits):
    ref, r = fits["EM_ref"]
    port, p = fits["EM_scan"]
    X, labels = fits["X"], fits["labels"]
    assert abs(r.n_iters - p.n_iters) <= 3, (r.n_iters, p.n_iters)
    assert _trace_rel(p.objective, r.objective) <= 2e-2
    assert abs(port.score(X, labels) - ref.score(X, labels)) <= 0.01
    r80, p80 = fits["EM_ref80"], fits["EM_80"]
    assert r80.n_iters == p80.n_iters == 80
    assert _rel(p80.weights, r80.weights) <= 5e-2
    assert p.weights.shape == (5, 21)
    assert set(p.aux_history) == {"objective"}


def test_mc_fit_band(fits):
    ref, r = fits["MC_ref"]
    port, p = fits["MC_long"]
    X, labels = fits["X"], fits["labels"]
    assert r.converged and p.converged, (r.n_iters, p.n_iters)
    assert abs(port.score(X, labels) - ref.score(X, labels)) <= 0.01
    assert _rel(p.weights, r.weights) <= 0.15
    assert port.score(X, labels) > 0.9


@pytest.mark.parametrize("algo", ["EM", "MC"])
def test_scan_equals_loop_exactly(fits, algo):
    _, s = fits[algo + "_scan"]
    _, lp = fits[algo + "_loop"]
    assert s.n_iters == lp.n_iters and s.converged == lp.converged
    assert np.array_equal(s.objective, lp.objective)
    assert np.array_equal(s.last_sample, lp.last_sample)
    np.testing.assert_allclose(s.weights, lp.weights, rtol=1e-6, atol=1e-7)
    assert s.n_host_syncs <= -(-_mlt_cfg(SVMConfig, algo).max_iters // 16)


def test_predict_and_score_are_class_ids(fits):
    port, _ = fits["EM_scan"]
    X, labels = fits["X"], fits["labels"]
    f = port.decision_function(X[:50])
    pred = port.predict(X[:50])
    assert f.shape == (50, 5) and f.dtype == np.float32
    assert np.array_equal(pred, np.argmax(f, axis=1))
    assert port.score(X, labels) == float(np.mean(port.predict(X) == labels))


# ------------------------------------------------------- Nystrom x MLT
@pytest.mark.parametrize("algo,band", [("EM", 1e-3), ("MC", 0.15)])
def test_nystrom_mlt_matches_reference(algo, band):
    """tests/test_nystrom.py's KRN-MLT problem: one nystrom_phi a step,
    then M passes on phi; the port fits on the reference's featurizer."""
    rng = np.random.default_rng(9)
    N, D, M = 900, 8, 3
    X = rng.normal(size=(N, D)).astype(np.float32)
    labels = np.argmax(np.abs(X @ rng.normal(size=(M, D)).T), 1
                       ).astype(np.int32)
    kw = dict(formulation="KRN", algorithm=algo, task="MLT", num_classes=M,
              lam=1.0, sigma=3.0, eps=1e-2, max_iters=10, min_iters=10)
    ref = JaxNystrom(JaxConfig(**kw), n_landmarks=48)
    r = ref.fit(X, labels)
    port = NystromSVM(SVMConfig(**kw), device="cpu")
    p = port.fit_featurized(X, labels, np.asarray(ref._landmarks),
                            np.asarray(ref._proj))
    assert p.weights.shape == (M, 49) == np.shape(r.weights)
    assert _rel(p.weights, r.weights) <= band
    assert abs(port.score(X, labels) - ref.score(X, labels)) <= 0.01
    assert port.decision_function(X[:7]).shape == (7, M)


# --------------------------------------------------------- conversion
@pytest.mark.parametrize("kind", ["lin", "nystrom"])
def test_reference_mlt_weights_predict_in_the_port(kind):
    """A reference MLT fit's W predicts in the port as in the reference:
    labels equal, margins within 1e-5 of max|ref|."""
    X, labels, M = _problem()
    kw = dict(task="MLT", num_classes=M, lam=1.0, max_iters=12)
    if kind == "lin":
        ref = JaxSVM(JaxConfig(**kw))
        r = ref.fit(X, labels)
        port = svm_from_reference(config_from_reference(
            dataclasses.asdict(ref.config)), r.weights, X.shape[1],
            device="cpu")
    else:
        ref = JaxNystrom(JaxConfig(formulation="KRN", sigma=4.0, **kw),
                         n_landmarks=40)
        r = ref.fit(X, labels)
        port = nystrom_from_reference(
            dataclasses.asdict(ref.config), np.asarray(ref._landmarks),
            np.asarray(ref._proj), r.weights, device="cpu")
    f_ref = np.asarray(ref.decision_function(X))
    f = port.decision_function(X)
    assert f.shape == f_ref.shape == (X.shape[0], M)
    assert np.max(np.abs(f - f_ref)) <= 1e-5 * np.max(np.abs(f_ref))
    assert np.array_equal(port.predict(X), np.asarray(ref.predict(X)))
    with pytest.raises(ValueError, match="needs"):
        svm_from_reference(SVMConfig(**kw), np.zeros(21, np.float32), 20,
                           device="cpu")


# ------------------------------------------------------------ refusals
def test_multichain_and_bad_labels_refused():
    with pytest.raises(AssertionError, match="MLT"):
        SVMConfig(algorithm="MC", rng="fused", task="MLT", num_classes=3,
                  n_chains=2)
    X, labels, _ = _problem()
    svm = PEMSVM(SVMConfig(task="MLT", num_classes=3), device="cpu")
    with pytest.raises(ValueError, match="class ids"):
        svm.fit(X, labels)


def test_runs_on_the_card_by_default():
    """``PEMSVM(SVMConfig.from_options("LIN-MC-MLT", num_classes=10))``
    picks cuda:0; without a card it says so instead of falling back."""
    cfg = SVMConfig.from_options("LIN-MC-MLT", num_classes=10)
    if torch.cuda.is_available():
        assert PEMSVM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PEMSVM(cfg)


# ---------------------------------------------------------------- mesh
_MESH_CODE = """
import dataclasses, datetime, sys
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
X, labels = d["X"], d["labels"]
res = {}
base = dict(task="MLT", num_classes=5, lam=1.0, max_iters=8, min_iters=8)
if world == 4:
    mesh = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                      mesh_dim_names=("data", "k"))
    for name, kw in (("em", {}), ("mc", dict(algorithm="MC"))):
        cfg = SVMConfig(pad_features=2, **base, **kw)
        r = PEMSVM(dataclasses.replace(cfg, k_shard_axis="k"),
                   device="cpu", mesh=mesh).fit(X, labels)
        res[name + "_w"], res[name + "_obj"] = r.weights, r.objective
        if rank == 0:
            r = PEMSVM(cfg, device="cpu").fit(X, labels)
            res[name + "_one_w"] = r.weights
            res[name + "_one_obj"] = r.objective
else:
    mesh = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64),
                      mesh_dim_names=("data", "k"))
    for name, kw in (("em", {}), ("mc", dict(algorithm="MC",
                                              rng="fused"))):
        for tag, m in (("one", None), ("mesh", mesh)):
            r = PEMSVM(SVMConfig(**base, **kw), device="cpu",
                       mesh=m).fit(X, labels)
            res[f"{name}_{tag}_w"] = r.weights
            res[f"{name}_{tag}_obj"] = np.asarray(r.objective)
np.savez(f"{out}/rank{rank}.npz", **{k: np.asarray(v) for k, v in
                                     res.items()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    X, labels, _ = _problem()
    out = {}
    for world in (4, 1):
        d = tmp_path_factory.mktemp(f"mlt_mesh{world}")
        np.savez(d / "inputs.npz", X=X, labels=labels)
        out[world] = run_ranks(_MESH_CODE, d, world=world)
    return out


@pytest.mark.parametrize("case", ["em", "mc"])
def test_kshard_mesh_ranks_bitwise_and_near_one_device(mesh, case):
    ranks = mesh[4]
    for r in ranks[1:]:
        assert np.array_equal(r[case + "_w"], ranks[0][case + "_w"])
        assert np.array_equal(r[case + "_obj"], ranks[0][case + "_obj"])
    w, one = ranks[0][case + "_w"], ranks[0][case + "_one_w"]
    assert w.shape == one.shape == (5, 22)
    assert _rel(w, one) <= 5e-2
    assert _trace_rel(ranks[0][case + "_obj"],
                      ranks[0][case + "_one_obj"]) <= 2e-2


@pytest.mark.parametrize("case", ["em", "mc"])
def test_one_rank_mesh_is_bitwise_the_one_device_fit(mesh, case):
    r = mesh[1][0]
    assert np.array_equal(r[case + "_mesh_w"], r[case + "_one_w"])
    assert np.array_equal(r[case + "_mesh_obj"], r[case + "_one_obj"])
