"""The port's data-parallel reduction (the paper's Sec 4.1 map-reduce) on a
``torch.distributed`` mesh against the JAX package's, on the CPU: four
gloo ranks with a file store, the reference's fits on four emulated
devices in one JAX subprocess.

1. Collectives in a world of four (exact where the arithmetic is exact):
   ``preduce`` with ``live`` all ones is bitwise the plain sum; with one
   replica at 0 it is the sum of the other three times 4/3 (within 1e-6
   relative: one rounding of the scale); ``masked_mean`` after a dropped
   shard is the mean over the surviving rows; ``reduce_stats`` with the
   packed triangle equals the dense reduce within 1e-6 max|S| (the same
   sums, which gloo associates by payload size), for one chain and for
   three packed chains;
   ``reduce_kshard`` on a 2 x 2 mesh rebuilds the one-device Sigma and b
   (within 1e-5 max|ref|, float32 sums in another order); a bfloat16
   payload stays within bfloat16's rounding (2^-8 relative, four terms)
   of the float32 reduce.
2. The bfloat16 clamp caveat of the reference (tests/test_distributed.py):
   at eps = 1e-3 a bfloat16-reduced fit keeps its accuracy within 0.02 of
   the float32 fit. At eps = 1e-6 a row at the hinge (residual 0, as
   support vectors reach it) weighs 1/eps = 1e6 in Sigma, and bfloat16's
   8-bit mantissa puts an error on the posterior precision P = lam I +
   Sigma whose 2-norm exceeds P's smallest eigenvalue: definiteness is no
   longer guaranteed (the reference's fit on its test data collapses to
   NaN there; the port's reaches no indefinite P on that trajectory, and a
   failed factorization gives NaN in both). At eps = 1e-3 the same rows
   leave the error below the smallest eigenvalue. Shown on each rank's
   statistic (264 normal rows, residuals U(-1, 1), the first at 0),
   reduced through the gloo collective in float32 and in bfloat16.
3. 4 x 1 data-parallel fits on make_alpha_like(4096, 23): LIN-EM-CLS, the
   same with one shard dead (live = [1, 1, 0, 1]), and LIN-MC-CLS
   rng='host', against the reference's mesh fits: EM iterations within 3,
   objective trace within 2e-2 relative, weights within 5e-2; MC weights
   within 0.15 and the first objective of the chain within 1e-6 of the
   port's one-device fit (draws keyed by global row). EM also against the
   port's one-device fit with the same bands. Every rank's weights are
   bitwise equal; the loop driver is bitwise the scan driver on the mesh;
   after 5 iterations the dense reduce (triangle_reduce=False) lands
   within 1e-3 relative of the triangle's (the reference's band). A
   one-rank mesh is bitwise the one-device fit (EM and MC).
"""
import numpy as np
import pytest

from repro_torch.data import make_alpha_like
from test_torch_kshard import (_rel, _trace_rel, finish, run_ranks,
                               run_reference)

_REF_CODE = """
import sys
import numpy as np
from repro import compat
from repro.core import PEMSVM, SVMConfig
d = np.load(sys.argv[1])
X, y = d["X"], d["y"]
mesh = compat.make_mesh((4,), ("data",), axis_types=("auto",))
out = {}
def rec(name, r):
    out[name + "_w"] = np.asarray(r.weights)
    out[name + "_obj"] = np.asarray(r.objective)
    out[name + "_it"] = r.n_iters
rec("em_cls", PEMSVM(SVMConfig(), mesh=mesh).fit(X, y))
rec("live", PEMSVM(SVMConfig(), mesh=mesh).fit(
    X, y, live=np.array([1, 1, 0, 1], np.float32)))
rec("mc_cls", PEMSVM(SVMConfig(algorithm="MC"), mesh=mesh).fit(X, y))
np.savez(sys.argv[2], **out)
"""

_PORT_CODE = """
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
from repro_torch.core import PEMSVM, SVMConfig, distributed, linear, stats
d = np.load(out + "/inputs.npz")
X, y = d["X"], d["y"]
mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
mesh22 = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                    mesh_dim_names=("data", "k"))
ax = distributed.axes_of(mesh, ("data",))
res = {"index": ax.index}
T = torch.from_numpy

# 1. collectives
g = np.random.default_rng(10 + ax.index)
x = T(g.normal(size=(5, 7)).astype(np.float32))
res["sum"] = stats.preduce(x, ax)
res["sum_live1"] = stats.preduce(x, ax, torch.tensor(1.0))
dead = torch.tensor(0.0 if ax.index == 2 else 1.0)
res["sum_dead"] = stats.preduce(x, ax, dead)
mk = T((g.random(11) > 0.3).astype(np.float32))
v = T(g.normal(size=11).astype(np.float32))
res["mmean_dead"] = stats.masked_mean(v, mk, ax, dead)
A = g.normal(size=(3, 7, 7)).astype(np.float32)
Sc, bc = T(A + A.transpose(0, 2, 1)), T(g.normal(size=(7, 3)).astype(
    np.float32))
for name, kw in (("tri", {}), ("dense", dict(triangle=False)),
                 ("bf16", dict(reduce_dtype="bfloat16"))):
    S1, b1 = stats.reduce_stats(Sc[0], bc[:, 0], ax, **kw)
    S3, b3 = stats.reduce_stats(Sc, bc, ax, **kw)
    res.update({name + "_S1": S1, name + "_b1": b1, name + "_S3": S3,
                name + "_b3": b3})
ad, ak = (distributed.axes_of(mesh22, (a,)) for a in ("data", "k"))
gk = np.random.default_rng(30)
Xk = gk.normal(size=(64, 10)).astype(np.float32)
wk, ck = gk.uniform(0.5, 2, 64).astype(np.float32), gk.normal(size=64)
rows = slice(32 * ad.index, 32 * ad.index + 32)
start, blk = linear._k_block(10, ak)
Xr = T(Xk[rows])
S_blk = (Xr * T(wk[rows])[:, None]).T @ Xr[:, start:start + blk]
res["kshard_S"], res["kshard_b"] = stats.reduce_kshard(
    S_blk, Xr.T @ T(ck[rows].astype(np.float32)), ad, ak)

# 2. the bfloat16 caveat: a shard statistic with one row at the hinge,
# reduced in float32 and in bfloat16
gc = np.random.default_rng(40 + ax.index)
Xs = T(gc.normal(size=(264, 24)).astype(np.float32))
r = gc.uniform(-1, 1, 264).astype(np.float32)
r[0] = 0.0
for eps in ("1e-3", "1e-6"):
    wt = 1.0 / T(np.maximum(np.abs(r), np.float32(eps)))
    S = (Xs * wt[:, None]).T @ Xs
    for dt in (None, "bfloat16"):
        res[f"caveat_{eps}_{dt}"] = stats.reduce_stats(
            S, Xs.T @ wt, ax, reduce_dtype=dt)[0]
for eps, dt in ((1e-3, None), (1e-3, "bfloat16")):
    m = PEMSVM(SVMConfig(max_iters=30, eps=eps, reduce_dtype=dt),
               device="cpu", mesh=mesh)
    m.fit(d["Xc"], d["yc"])
    res[f"acc_{eps}_{dt}"] = m.score(d["Xc"], d["yc"])

# 3. fits
def rec(name, r):
    res[name + "_w"] = r.weights
    res[name + "_obj"] = np.asarray(r.objective)
    res[name + "_it"] = r.n_iters
def fit(name, cfg, **kw):
    rec(name, PEMSVM(cfg, device="cpu", mesh=mesh).fit(X, y, **kw))
fit("em_cls", SVMConfig())
fit("live", SVMConfig(), live=[1, 1, 0, 1])
fit("mc_cls", SVMConfig(algorithm="MC"))
fit("loop", SVMConfig(driver="loop"))
fit("tri5", SVMConfig(max_iters=5))
fit("dense", SVMConfig(max_iters=5, triangle_reduce=False))
if rank == 0:
    rec("em_cls_one", PEMSVM(SVMConfig(), device="cpu").fit(X, y))
    rec("mc_cls_one", PEMSVM(SVMConfig(algorithm="MC"), device="cpu").fit(
        X, y))
try:
    PEMSVM(SVMConfig(), device="cpu", mesh=mesh).fit(X, y, live=[1, 0])
    res["live_error"] = "no error"
except ValueError as e:
    res["live_error"] = str(e)
np.savez(f"{out}/rank{rank}.npz", **{k: np.asarray(v) for k, v in
                                     res.items()})
dist.destroy_process_group()
"""


_ONE_RANK_CODE = """
import sys
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
X, y = d["X"], d["y"]
mesh = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64),
                  mesh_dim_names=("data", "k"))
res = {}
for name, kw in (("em", {}), ("mc", dict(algorithm="MC", rng="fused"))):
    for tag, m in (("one", None), ("mesh", mesh)):
        r = PEMSVM(SVMConfig(**kw), device="cpu", mesh=m).fit(X, y)
        res[f"{name}_{tag}_w"] = r.weights
        res[f"{name}_{tag}_obj"] = np.asarray(r.objective)
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _caveat_data():
    """The data of the reference's bf16 test (tests/test_distributed.py)."""
    rng = np.random.default_rng(0)
    N, K = 1037, 23
    w_true = rng.normal(size=K)
    X = rng.normal(size=(N, K)).astype(np.float32)
    y = np.where(X @ w_true + 0.3 * rng.normal(size=N) > 0, 1.0,
                 -1.0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("distributed")
    X, y = make_alpha_like(4096, 23, seed=0)
    np.savez(out / "data.npz", X=X, y=y)
    ref = run_reference(_REF_CODE, [out / "data.npz", out / "ref.npz"])
    Xc, yc = _caveat_data()
    np.savez(out / "inputs.npz", X=X, y=y, Xc=Xc, yc=yc)
    ranks = run_ranks(_PORT_CODE, out)
    one = tmp_path_factory.mktemp("one_rank")
    np.savez(one / "inputs.npz", X=X, y=y)
    ranks.append(run_ranks(_ONE_RANK_CODE, one, world=1)[0])
    finish(ref)
    return dict(np.load(out / "ref.npz")), ranks


def _inputs(index):
    g = np.random.default_rng(10 + index)
    x = g.normal(size=(5, 7)).astype(np.float32)
    mk = (g.random(11) > 0.3).astype(np.float32)
    v = g.normal(size=11).astype(np.float32)
    A = g.normal(size=(3, 7, 7)).astype(np.float32)
    S = A + A.transpose(0, 2, 1)
    b = g.normal(size=(7, 3)).astype(np.float32)
    return x, mk, v, S, b


# ------------------------------------------------------- 1. collectives
def test_preduce_live_all_ones_is_bitwise_the_plain_sum(world):
    for r in world[1][:4]:
        assert np.array_equal(r["sum_live1"], r["sum"])
        assert np.array_equal(r["sum"], world[1][0]["sum"])
    want = sum(_inputs(i)[0].astype(np.float64) for i in range(4))
    np.testing.assert_allclose(world[1][0]["sum"], want, rtol=1e-6,
                               atol=1e-6)


def test_preduce_dead_replica_drops_out_and_renormalizes(world):
    xs = [_inputs(i)[0].astype(np.float64) for i in range(4)]
    want = (xs[0] + xs[1] + xs[3]) * 4.0 / 3.0
    for r in world[1][:4]:
        np.testing.assert_allclose(r["sum_dead"], want, rtol=1e-6,
                                   atol=1e-6)


def test_masked_mean_after_a_dropped_shard(world):
    ins = [_inputs(i) for i in (0, 1, 3)]
    num = sum(float(np.sum(v.astype(np.float64) * mk))
              for _, mk, v, _, _ in ins)
    den = sum(float(np.sum(mk)) for _, mk, _, _, _ in ins)
    for r in world[1][:4]:
        assert float(r["mmean_dead"]) == pytest.approx(num / den, rel=1e-6)


@pytest.mark.parametrize("chains", [1, 3])
def test_reduce_stats_triangle_equals_dense(world, chains):
    ins = [_inputs(i) for i in range(4)]
    S = sum(x[3].astype(np.float64) for x in ins)
    b = sum(x[4].astype(np.float64) for x in ins)
    if chains == 1:
        S, b = S[0], b[:, 0]
    for r in world[1][:4]:
        for key, want in (("S", S), ("b", b)):
            tri, dense = r[f"tri_{key}{chains}"], r[f"dense_{key}{chains}"]
            assert tri.shape == want.shape
            assert np.max(np.abs(tri - dense)) <= 1e-6 * np.max(np.abs(tri))
        np.testing.assert_allclose(r[f"tri_S{chains}"], S, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"tri_b{chains}"], b, rtol=1e-5,
                                   atol=1e-5)


def test_reduce_stats_bf16_payload_within_its_rounding(world):
    for r in world[1][:4]:
        for key in ("S3", "b3"):
            got, want = r["bf16_" + key], r["tri_" + key]
            assert got.dtype == np.float32
            scale = sum(np.abs(_inputs(i)[3 if key == "S3" else 4])
                        for i in range(4))
            assert np.all(np.abs(got - want) <= 4 * 2.0 ** -8 * scale)


def test_reduce_kshard_rebuilds_the_one_device_sigma(world):
    gk = np.random.default_rng(30)
    X = gk.normal(size=(64, 10)).astype(np.float64)
    w, c = gk.uniform(0.5, 2, 64), gk.normal(size=64)
    S = (X * w.astype(np.float32)[:, None]).T @ X
    b = X.T @ c.astype(np.float32)
    for r in world[1][:4]:
        assert r["kshard_S"].shape == (10, 10)
        assert np.max(np.abs(r["kshard_S"] - S)) <= 1e-5 * np.max(np.abs(S))
        assert np.max(np.abs(r["kshard_b"] - b)) <= 1e-5 * np.max(np.abs(b))


# ------------------------------------------------- 2. the bf16 caveat
def test_bf16_reduce_clamp_caveat(world):
    r = world[1][0]
    assert abs(float(r["acc_0.001_None"])
               - float(r["acc_0.001_bfloat16"])) < 0.02
    K = r["caveat_1e-3_None"].shape[0]
    for eps, unsafe in (("1e-3", False), ("1e-6", True)):
        P = r[f"caveat_{eps}_None"].astype(np.float64) + np.eye(K)
        err = r[f"caveat_{eps}_bfloat16"] - r[f"caveat_{eps}_None"]
        gap = np.linalg.norm(err.astype(np.float64), 2)
        assert (gap > np.linalg.eigvalsh(P)[0]) == unsafe, (eps, gap)


# ---------------------------------------------------------- 3. fits
@pytest.mark.parametrize("case", ["em_cls", "live", "mc_cls", "loop",
                                  "dense"])
def test_data_parallel_ranks_bitwise_equal(world, case):
    ranks = world[1][:4]
    for r in ranks[1:]:
        assert np.array_equal(r[case + "_w"], ranks[0][case + "_w"])


@pytest.mark.parametrize("case", ["em_cls", "live"])
def test_data_parallel_em_vs_reference(world, case):
    ref, ranks = world
    p = ranks[0]
    assert abs(int(p[case + "_it"]) - int(ref[case + "_it"])) <= 3
    assert _trace_rel(p[case + "_obj"], ref[case + "_obj"]) <= 2e-2
    assert _rel(p[case + "_w"], ref[case + "_w"]) <= 5e-2


def test_data_parallel_em_vs_one_device(world):
    p = world[1][0]
    assert abs(int(p["em_cls_it"]) - int(p["em_cls_one_it"])) <= 3
    assert _trace_rel(p["em_cls_obj"], p["em_cls_one_obj"]) <= 2e-2
    assert _rel(p["em_cls_w"], p["em_cls_one_w"]) <= 5e-2


def test_dead_shard_changes_the_fit(world):
    """Dropping a quarter of the rows moves the weights (the renormalized
    statistic is an estimate, not the full sum) but keeps the fit close."""
    p = world[1][0]
    assert 0 < _rel(p["live_w"], p["em_cls_w"]) <= 0.5


def test_data_parallel_mc_chain(world):
    ref, ranks = world
    p = ranks[0]
    o, o1 = p["mc_cls_obj"], p["mc_cls_one_obj"]
    assert abs(o[0] - o1[0]) <= 1e-6 * abs(o1[0])
    assert _rel(p["mc_cls_w"], ref["mc_cls_w"]) <= 0.15
    assert _rel(p["mc_cls_w"], p["mc_cls_one_w"]) <= 0.15


def test_loop_driver_is_bitwise_the_scan_driver_on_the_mesh(world):
    p = world[1][0]
    assert np.array_equal(p["loop_w"], p["em_cls_w"])
    assert np.array_equal(p["loop_obj"], p["em_cls_obj"])


def test_dense_reduce_within_the_reference_band(world):
    p = world[1][0]
    np.testing.assert_allclose(p["dense_w"], p["tri5_w"], rtol=1e-3,
                               atol=1e-4)


def test_live_of_the_wrong_shape_raises(world):
    for r in world[1][:4]:
        assert "one weight per data shard" in str(r["live_error"])


@pytest.mark.parametrize("case", ["em", "mc"])
def test_one_rank_mesh_is_bitwise_the_one_device_fit(world, case):
    """A 1 x 1 mesh (one gloo rank) runs every collective of the mesh path
    and gives the one-device fit bitwise: live = 1 and the packed
    triangle of the symmetrized Sigma are exact."""
    r = world[1][4]
    assert np.array_equal(r[case + "_mesh_w"], r[case + "_one_w"])
    assert np.array_equal(r[case + "_mesh_obj"], r[case + "_one_obj"])
