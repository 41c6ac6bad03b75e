"""The port's MaxMarginHead (``repro_torch.core.head``) against the JAX
package's on the CPU, on the task of tests/test_system.py's composite
head test: a frozen two-layer SmolLM backbone (vocabulary 64) pools
features of 400 token-range documents and PEMSVM (lam 0.1, max_iters 40)
fits the readout.

The backbone computes in float32 here (the reference config's default
is bfloat16, where the two frameworks' roundings alone move the features
by ~4e-3), so that the features can be held to 1e-4 of max|ref|.

The head's weights are held within 1e-3 of max|w| after two EM
iterations. At convergence they are held to the reference's own spread:
the task is separable, rows reach the hinge and weigh up to 1/eps, and
last-bit differences grow ~25x an iteration (the reference fitted on its
own features moved by one ulp lands ~15 % of max|w| away, at another
iteration count). There the port must be within 3x that spread, its
iterations within 3 and its accuracy within 0.01 of the reference's.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as rget
from repro.core import MaxMarginHead as RefHead
from repro.core import PEMSVM as RefPEMSVM
from repro.core import SVMConfig as RefConfig
from repro.core import last_token_pool as ref_last_token_pool
from repro.core import mean_pool as ref_mean_pool
from repro.models import build_model as rbuild
from repro_torch.checkpoint.checkpointer import _tree_flatten_with_names
from repro_torch.core import (MaxMarginHead, SVMConfig, last_token_pool,
                              mean_pool)
from repro_torch.core.convert import lm_params_from_reference

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_kshard import run_ranks  # noqa: E402

FEAT_BAND, EARLY_W_BAND = 1e-4, 1e-3


def _task():
    rng = np.random.default_rng(0)
    N, S = 400, 16
    toks = np.where(rng.random((N, 1)) > 0.5,
                    rng.integers(0, 24, (N, S)),
                    rng.integers(40, 64, (N, S))).astype(np.int32)
    return toks, np.where(toks.mean(1) < 32, 1.0, -1.0)


def _wrel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def heads():
    """The reference's and the port's head on one backbone's weights."""
    cfg = reduce_cfg(rget("smollm-135m"), n_layers=2, vocab=64,
                     dtype="float32")
    rm = rbuild(cfg, q_chunk=16, kv_chunk=16)
    rp = rm.init(jax.random.PRNGKey(0))

    def ref_feature_fn(tokens):
        h = rm.hidden_seq(rp, {"tokens": tokens}, remat=False)
        return ref_mean_pool(h.astype(jnp.float32))

    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray, rp))
    pm = lm_params_from_reference(dataclasses.asdict(cfg),
                                  dict(zip(names, leaves)), device="cpu",
                                  q_chunk=16, kv_chunk=16)

    def feature_fn(tokens):
        return mean_pool(pm.hidden_seq({"tokens": tokens}).float())

    return ref_feature_fn, feature_fn


def test_pools_match_reference():
    g = np.random.default_rng(2)
    h = g.normal(size=(3, 7, 5)).astype(np.float32)
    mask = (g.random((3, 7)) > 0.4).astype(np.float32)
    mask[2] = 0.0                                  # an empty row
    lengths = np.array([7, 1, 0], np.int32)
    th, jh = torch.from_numpy(h), jnp.asarray(h)
    np.testing.assert_allclose(mean_pool(th).numpy(),
                               np.asarray(ref_mean_pool(jh)), rtol=1e-6)
    np.testing.assert_allclose(
        mean_pool(th, torch.from_numpy(mask)).numpy(),
        np.asarray(ref_mean_pool(jh, jnp.asarray(mask))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_array_equal(
        last_token_pool(th, torch.from_numpy(lengths)).numpy(),
        np.asarray(ref_last_token_pool(jh, jnp.asarray(lengths))))


def test_head_matches_reference(heads):
    ref_fn, port_fn = heads
    toks, y = _task()
    ref = RefHead(RefConfig(lam=0.1, max_iters=40), ref_fn)
    port = MaxMarginHead(SVMConfig(lam=0.1, max_iters=40), port_fn,
                         device="cpu", feature_batch=96)
    fr, fp = ref.extract(toks), port.extract(toks)
    assert fp.dtype == np.float32 and fp.shape == (400, 64)
    assert _wrel(fp, fr) <= FEAT_BAND
    rr, rp = ref.fit(toks, y), port.fit(toks, y)
    assert abs(rr.n_iters - rp.n_iters) <= 3
    acc_r, acc_p = ref.score(toks, y), port.score(toks, y)
    assert acc_r > 0.9 and abs(acc_r - acc_p) <= 0.01
    np.testing.assert_array_equal(port.predict(toks),
                                  port.svm.predict(fp))
    # the reference's own spread: its fit on its features moved one ulp
    fq = np.nextafter(fr, np.float32(np.inf))
    spread = _wrel(RefPEMSVM(RefConfig(lam=0.1, max_iters=40)).fit(
        fq, y).weights, rr.weights)
    assert _wrel(rp.weights, rr.weights) <= 3 * spread, spread


def test_head_weights_after_two_iterations(heads):
    ref_fn, port_fn = heads
    toks, y = _task()
    cfg = dict(lam=0.1, max_iters=2, min_iters=2)
    ref = RefHead(RefConfig(**cfg), ref_fn).fit(toks, y)
    port = MaxMarginHead(SVMConfig(**cfg), port_fn, device="cpu").fit(
        toks, y)
    assert _wrel(port.weights, ref.weights) <= EARLY_W_BAND
    np.testing.assert_allclose(port.objective, ref.objective, rtol=1e-5)


def test_head_svr_rmse(heads):
    """score is the negated RMSE and rmse the solver's RMSE on the
    extracted features for an SVR head; it explains the target."""
    _, port_fn = heads
    toks, y = _task()
    target = toks.mean(1).astype(np.float32) / 64
    head = MaxMarginHead(SVMConfig.from_options("LIN-EM-SVR", lam=0.1,
                                                eps_ins=0.01, max_iters=20),
                         port_fn, device="cpu")
    head.fit(toks, target)
    rmse = head.rmse(toks, target)
    assert rmse == head.svm.rmse(head.extract(toks), target)
    assert head.score(toks, target) == -rmse and rmse < 0.5 * target.std()


def test_head_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaxMarginHead(SVMConfig(), lambda t: t)


# reduce_cfg(smollm-135m, n_layers=2, vocab=64, dtype="float32"), spelt
# out for the rank processes, which import neither JAX nor the tests
_BACKBONE = dict(n_layers=2, d_model=64, vocab=64, d_ff=128, n_heads=4,
                 n_kv_heads=2, head_dim=16, dtype="float32")

_RANK_CODE = """
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
from repro_torch.configs import get_config
from repro_torch.core import MaxMarginHead, SVMConfig, mean_pool
from repro_torch.models import build_model
d = np.load(out + "/task.npz")
toks, y = d["toks"], d["y"]
cfg = dataclasses.replace(get_config("smollm-135m"), **BACKBONE)
model = build_model(cfg, device="cpu", q_chunk=16, kv_chunk=16)
model.init(0)
feature_fn = lambda t: mean_pool(model.hidden_seq({"tokens": t}).float())
mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
res = {}
for name, kw in (("full", dict(max_iters=40)),
                 ("two", dict(max_iters=2, min_iters=2))):
    head = MaxMarginHead(SVMConfig(lam=0.1, **kw), feature_fn, mesh=mesh,
                         data_axes=("data",), device="cpu")
    r = head.fit(toks, y)
    res[name + "_w"], res[name + "_it"] = r.weights, r.n_iters
    res[name + "_acc"] = head.score(toks, y)
np.savez(out + f"/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def test_head_on_a_two_rank_gloo_mesh(tmp_path):
    """Two gloo ranks, each extracting the same features: the fit reduces
    over the data axis. Both ranks' weights bitwise equal; against the
    port's fit without a mesh: 2-iteration weights within 1e-3 of
    max|w|, and at convergence iterations within 3, accuracy within
    0.01."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = reduce_cfg(get_config("smollm-135m"), n_layers=2, vocab=64,
                     dtype="float32")
    assert cfg == dataclasses.replace(get_config("smollm-135m"), **_BACKBONE)
    toks, y = _task()
    np.savez(tmp_path / "task.npz", toks=toks, y=y)
    ranks = run_ranks(_RANK_CODE.replace("BACKBONE", repr(_BACKBONE)),
                      tmp_path, world=2)
    for name in ("full", "two"):
        np.testing.assert_array_equal(ranks[0][name + "_w"],
                                      ranks[1][name + "_w"])
    model = build_model(cfg, device="cpu", q_chunk=16, kv_chunk=16)
    model.init(0)

    def fn(t):
        return mean_pool(model.hidden_seq({"tokens": t}).float())

    one = MaxMarginHead(SVMConfig(lam=0.1, max_iters=2, min_iters=2), fn,
                        device="cpu").fit(toks, y)
    assert _wrel(ranks[0]["two_w"], one.weights) <= EARLY_W_BAND
    head = MaxMarginHead(SVMConfig(lam=0.1, max_iters=40), fn, device="cpu")
    full = head.fit(toks, y)
    assert abs(int(ranks[0]["full_it"]) - full.n_iters) <= 3
    assert abs(float(ranks[0]["full_acc"]) - head.score(toks, y)) <= 0.01
