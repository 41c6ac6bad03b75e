"""The port's LIN-EM-CLS fit against the JAX package's on the quickstart
problem, plus the port's own driver, data, config and conversion checks.

Bands are about 3-5x the drift measured between two correct float32 EM
implementations that sum in different orders (weights 0.4-1.0 % apart,
objective traces 0.36 %, iteration counts 48 vs 49 against a float64 EM):
|d n_iters| <= 3, objective over the common prefix within 2e-2 relative,
final weights within relative error 5e-2, held-out accuracy within 0.01.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.core import PEMSVM as JaxSVM
from repro.core import objective as jobj
from repro.core import SVMConfig as JaxConfig
from repro.data import synthetic as jsyn
from repro_torch.core import PEMSVM, PhiSpec, SVMConfig, lam_from_C
from repro_torch.core import objective as tobj
from repro_torch.core.convert import config_from_reference, svm_from_reference
from repro_torch.data import synthetic as tsyn



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once, and timing-based tests elsewhere feel the contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _quickstart():
    X, y = tsyn.make_blobs(20_000, 100, seed=0)
    return X[:16_000], y[:16_000], X[16_000:], y[16_000:]


def _cfg(cls, **kw):
    return cls.from_options("LIN-EM-CLS",
                            **{"lam": lam_from_C(1.0), "max_iters": 100, **kw})


@pytest.fixture(scope="module")
def fits():
    Xtr, ytr, Xte, yte = _quickstart()
    ref = JaxSVM(_cfg(JaxConfig))
    r_ref = ref.fit(Xtr, ytr)
    port = PEMSVM(_cfg(SVMConfig), device="cpu")
    r_port = port.fit(Xtr, ytr)
    return dict(ref=ref, r_ref=r_ref, port=port, r_port=r_port, Xte=Xte,
                yte=yte)


def test_both_converge_in_similar_iterations(fits):
    r, p = fits["r_ref"], fits["r_port"]
    assert r.converged and p.converged
    assert abs(r.n_iters - p.n_iters) <= 3, (r.n_iters, p.n_iters)


def test_objective_trace_band(fits):
    r = np.asarray(fits["r_ref"].objective, np.float64)
    p = np.asarray(fits["r_port"].objective, np.float64)
    n = min(len(r), len(p))
    rel = np.abs(p[:n] - r[:n]) / np.abs(r[:n])
    assert rel.max() <= 2e-2, rel.max()


def test_final_weights_band(fits):
    r = np.asarray(fits["r_ref"].weights, np.float64)
    p = np.asarray(fits["r_port"].weights, np.float64)
    assert np.linalg.norm(p - r) / np.linalg.norm(r) <= 5e-2


def test_heldout_accuracy_band(fits):
    a_ref = fits["ref"].score(fits["Xte"], fits["yte"])
    a_port = fits["port"].score(fits["Xte"], fits["yte"])
    assert abs(a_ref - a_port) <= 0.01, (a_ref, a_port)
    assert a_port >= 0.95


@pytest.mark.parametrize("max_iters,chunk,tol", [
    (100, 16, 1e-3),   # quickstart protocol: converges mid-chunk
    (40, 7, 0.0),      # full budget, ragged last chunk
    (30, 64, 0.0),     # one chunk larger than the budget
])
def test_scan_equals_loop_exactly(max_iters, chunk, tol):
    """Same step, same ordering: traces and weights are bitwise equal,
    and the scan driver syncs once per chunk."""
    Xtr, ytr, _, _ = _quickstart()
    kw = dict(max_iters=max_iters, scan_chunk=chunk, tol=tol,
              min_iters=10 if tol else max_iters)
    scan = PEMSVM(_cfg(SVMConfig, **kw), device="cpu").fit(Xtr, ytr)
    loop = PEMSVM(_cfg(SVMConfig, driver="loop", **kw),
                  device="cpu").fit(Xtr, ytr)
    assert scan.objective == loop.objective
    assert scan.aux_history == loop.aux_history
    assert np.array_equal(scan.weights, loop.weights)
    assert (scan.n_iters, scan.converged) == (loop.n_iters, loop.converged)
    assert len(scan.objective) == scan.n_iters
    assert scan.n_host_syncs <= math.ceil(max_iters / chunk)
    assert loop.n_host_syncs == loop.n_iters


@pytest.mark.parametrize("fn,kw", [
    ("make_blobs", dict(n=301, k=17, seed=3)),
    ("make_blobs", dict(n=2000, k=20, seed=0, margin_noise=0.3)),
    ("make_alpha_like", dict(n=500, k=50, seed=0)),
    ("make_alpha_like", dict(n=257, k=33, seed=7, margin_noise=0.1)),
])
def test_synthetic_bitwise(fn, kw):
    Xt, yt = getattr(tsyn, fn)(**kw)
    Xj, yj = getattr(jsyn, fn)(**kw)
    assert Xt.dtype == Xj.dtype and yt.dtype == yj.dtype
    assert np.array_equal(Xt, Xj) and np.array_equal(yt, yj)


def test_config_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port = {f.name: f.default for f in dataclasses.fields(SVMConfig)}
    assert list(port) == list(ref)
    assert port == ref
    assert SVMConfig().jitter == JaxConfig().jitter


def test_config_from_reference_round_trip():
    ref = JaxConfig.from_options("LIN-EM-CLS", lam=0.5, max_iters=33,
                                 scan_chunk=5, tol=2e-3, backend="interpret")
    port = config_from_reference(dataclasses.asdict(ref))
    want = dict(dataclasses.asdict(ref), backend=None)
    assert dataclasses.asdict(port) == want
    with pytest.raises(ValueError):
        config_from_reference(dict(dataclasses.asdict(ref), bogus=1))


def test_svm_from_reference_scores_like_reference(fits):
    ref, r_ref = fits["ref"], fits["r_ref"]
    port = svm_from_reference(config_from_reference(
        dataclasses.asdict(ref.config)), r_ref.weights, 100, device="cpu")
    Xte, yte = fits["Xte"], fits["yte"]
    f_ref = np.asarray(ref.decision_function(Xte), np.float64)
    f_port = port.decision_function(Xte)
    assert f_port.dtype == np.float32 and f_port.shape == f_ref.shape
    # rtol 1e-5 relative to the margin scale: max|d| <= 1e-5 max|ref|
    assert np.max(np.abs(f_port - f_ref)) <= 1e-5 * np.max(np.abs(f_ref))
    assert np.array_equal(port.predict(Xte), ref.predict(Xte))
    assert port.score(Xte, yte) == ref.score(Xte, yte)


@pytest.mark.parametrize("masked", [False, True])
def test_objective_terms_match_reference(masked):
    g = np.random.default_rng(5)
    m = g.normal(size=203).astype(np.float32)
    y = g.choice([-1.0, 1.0], 203).astype(np.float32)
    mask = (g.random(203) > 0.3).astype(np.float32)
    w = g.normal(size=29).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(
        float(tobj.hinge_obj_terms(T(m), T(y), T(mask))),
        float(jobj.hinge_obj_terms(m, y, mask)), rtol=1e-6)
    np.testing.assert_allclose(float(tobj.l2_reg(T(w), 0.7)),
                               float(jobj.l2_reg(w, 0.7)), rtol=1e-6)
    pred = np.sign(m).astype(np.float32)
    mk = mask if masked else None
    assert float(tobj.accuracy(T(pred), T(y), None if mk is None else T(mk))
                 ) == pytest.approx(float(jobj.accuracy(pred, y, mk)),
                                    abs=1e-7)


@pytest.mark.parametrize("kw", [
    dict(fault=object(), driver="stream"),
    dict(fault=object()),
    dict(decay=0.5, driver="scan"),
    dict(window=2, decay=0.5, driver="stream"),
])
def test_unsupported_config_raises(kw):
    """``fault`` must be a ``runtime.FaultPolicy`` (the reference fails
    later, on the object's missing fields); ``decay`` and ``window`` hold
    the reference's guards: stream driver only, and not both."""
    if "fault" in kw:
        with pytest.raises(TypeError, match="FaultPolicy"):
            PEMSVM(SVMConfig(**kw), device="cpu")
        return
    with pytest.raises(AssertionError,
                       match="requires driver='stream'|pick one"):
        SVMConfig(**kw)


_KSHARD_FIT = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.core import PEMSVM, SVMConfig
d = np.load(out + "/inputs.npz")
mesh = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64),
                  mesh_dim_names=("data", "model"))
svm = PEMSVM(SVMConfig(**json.loads(str(d["kw"]))), device="cpu",
             mesh=mesh)
res = svm.fit(d["X"], d["y"])
np.savez(f"{out}/rank{rank}.npz", pred=svm.predict(d["X"]),
         score=svm.score(d["X"], d["y"]), keys=sorted(res.aux_history))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("kw", [
    dict(algorithm="MC", task="MLT", num_classes=3),
    dict(task="MLT", num_classes=3),
    dict(formulation="KRN"),
    dict(task="MLT", num_classes=3, k_shard_axis="model"),
    dict(formulation="KRN", k_shard_axis="model"),
])
def test_mlt_and_krn_configs_fit(kw, tmp_path):
    """The MLT and exact-KRN configurations this file once held as not
    ported fit now: on the CPU, and with a k_shard_axis on a one-rank
    (data x model) mesh (MLT shares one Sigma window over its class
    passes; the exact KRN solver leaves the k axis out of its data axes).
    MLT predicts class ids and scores their accuracy; KRN predicts +-1."""
    from test_torch_kshard import run_ranks
    mlt = kw.get("task") == "MLT"
    if mlt:
        rng = np.random.default_rng(3)
        X = rng.normal(size=(300, 6)).astype(np.float32)
        y = np.argmax(X[:, :3], axis=1).astype(np.int32)
        kw = dict(kw, pad_features=2)  # K = 7 -> 8, divisible by the k axis
    else:
        X, y = tsyn.make_circles(200)
        kw = dict(kw, sigma=0.7, lam=0.1)
    kw = dict(kw, max_iters=12)
    if "k_shard_axis" in kw:
        np.savez(tmp_path / "inputs.npz", X=X, y=y, kw=json.dumps(kw))
        r = run_ranks(_KSHARD_FIT, tmp_path, world=1)[0]
        keys, pred, score = set(r["keys"].tolist()), r["pred"], r["score"]
    else:
        svm = PEMSVM(SVMConfig(**kw), device="cpu")
        res = svm.fit(X, y)
        keys, pred, score = (set(res.aux_history), svm.predict(X),
                             svm.score(X, y))
    assert keys == ({"objective"} if mlt else {"objective", "gamma_mean"})
    assert set(np.unique(pred).tolist()) <= (set(range(3)) if mlt
                                             else {-1, 1})
    assert float(score) > 0.9


@pytest.mark.parametrize("kw", [
    dict(task="SVR"),
    dict(phi_spec=PhiSpec(), add_bias=False, task="SVR"),
    dict(algorithm="MC", rng="fused", task="SVR"),
    dict(algorithm="MC", rng="fused", n_chains=2, task="SVR"),
])
def test_svr_configs_fit(kw):
    """The SVR configurations this file once held as not ported fit now:
    X-space, phi-space (the NystromSVM delegate, given a featurizer), MC
    with the counter seed, and two chains; predict gives the regression
    values and score the negated RMSE."""
    X, y = tsyn.make_year_like(400, 6, seed=1)
    svm = PEMSVM(SVMConfig(lam=1.0, eps_ins=0.3, max_iters=12, **kw),
                 device="cpu")
    if svm.config.phi_spec is not None:
        L = X[:9].copy()
        svm._phi_arrays = (L, np.eye(9, dtype=np.float32))
    res = svm.fit(X, y)
    assert set(res.aux_history) == {"objective", "gamma_mean", "omega_mean"}
    assert np.all(np.isfinite(res.weights)) and len(res.objective) >= 10
    pred = svm.predict(X)
    assert pred.dtype == np.float32 and pred.shape == y.shape
    assert svm.score(X, y) == -svm.rmse(X, y)
    assert svm.rmse(X, y) < float(np.std(y))


def test_pad_features_and_k_shard_axis_configs():
    """Two options this file once held as not ported: pad_features fits
    on one device (zero columns after the bias, their weights exactly 0,
    predictions through the same padding), and k_shard_axis names an axis
    of a device mesh, so without one it is refused."""
    X, y = tsyn.make_blobs(400, 5, seed=1)
    svm = PEMSVM(SVMConfig(pad_features=8, max_iters=15), device="cpu")
    res = svm.fit(X, y)
    assert res.weights.shape == (8,) and np.all(res.weights[6:] == 0.0)
    assert svm.score(X, y) > 0.9
    with pytest.raises(ValueError, match="mesh"):
        PEMSVM(SVMConfig(k_shard_axis="model"), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(resume_from="ckpt"), dict(warm_start=(3,)), dict(resume_step=3),
    dict(fault_hook="kill at 2"), dict(epoch=3),
])
def test_unsupported_fit_keyword_raises(kw, tmp_path):
    """The elastic keywords' guards, as the reference's: a donor of
    another width (``warm_start``), ``resume_from`` with ``warm_start``,
    ``resume_step`` without ``resume_from``, a ``fault_hook`` that
    preempts, and an ``epoch`` below the directory's fence."""
    from repro_torch.checkpoint import advance_fence
    from repro_torch.runtime import FaultPolicy, faults
    X, y = tsyn.make_blobs(64, 4, seed=1)
    donor = PEMSVM(SVMConfig(max_iters=3), device="cpu").fit(
        np.ones((8, 3), np.float32), np.where(np.arange(8) % 2, 1.0, -1.0))
    if "warm_start" in kw:
        with pytest.raises(ValueError, match="warm_start weights have"):
            PEMSVM(SVMConfig(), device="cpu").fit(X, y, warm_start=donor)
        return
    if "resume_from" in kw:
        with pytest.raises(ValueError, match="mutually exclusive"):
            PEMSVM(SVMConfig(), device="cpu").fit(X, y, warm_start=donor,
                                                  **kw)
        return
    if "resume_step" in kw:
        with pytest.raises(ValueError, match="without resume_from"):
            PEMSVM(SVMConfig(), device="cpu").fit(X, y, **kw)
        return
    if "fault_hook" in kw:
        with pytest.raises(faults.SimulatedPreemption):
            PEMSVM(SVMConfig(), device="cpu").fit(
                X, y, fault_hook=faults.kill_at_iteration(2))
        return
    advance_fence(str(tmp_path), 5)
    cfg = SVMConfig(fault=FaultPolicy(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="superseded"):
        PEMSVM(cfg, device="cpu").fit(X, y, **kw)


def test_live_needs_a_mesh():
    X, y = tsyn.make_blobs(64, 4, seed=1)
    with pytest.raises(ValueError, match="needs a mesh"):
        PEMSVM(SVMConfig(), device="cpu").fit(X, y, live=[1.0])


def test_mesh_raises():
    """A mesh is now ported; what is not a torch DeviceMesh is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        PEMSVM(SVMConfig(), device="cpu", mesh=object())


def test_no_card_raises_instead_of_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is cuda:0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PEMSVM(SVMConfig())
