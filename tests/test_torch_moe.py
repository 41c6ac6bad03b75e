"""The port's MoE family (``models/mlp.py``'s ``init_moe``, ``_route``,
``_expert_pass``, ``moe_apply``; the MoE blocks of ``models/transformer``;
``Model`` with ``family == "moe"``) against the JAX package on the CPU, at
the reduced granite-moe-1b-a400m (``conftest.reduce_cfg``: 4 experts,
top-2) on numpy-seeded inputs.

Bands, fixed before the first comparison:

* ``init(seed)``: every leaf within 2e-6 of max|leaf|
  (tests/test_torch_lm.py's band);
* routing: expert ids equal, gates within 1e-6; every routed row's
  probabilities have no exact tie and a gap over 1e-6 between the k-th
  and the (k+1)-th (a near-tie would fail loudly, not flake);
* ``_expert_pass``'s keep mask and queue positions equal, at a capacity
  factor of 0.5 (drops) and at one that drops nothing;
* ``moe_apply``, hidden states, logits, prefill caches and decode logits
  within 1e-4 of max|ref| in float32 and 3e-2 in bfloat16
  (tests/test_torch_lm.py's bands). In bfloat16 the reference is run
  eagerly (``jax.disable_jit``): under ``jit`` XLA rounds bfloat16
  elsewhere, and where that moves a route or a capacity drop the jitted
  reference lands up to 0.3 of max|ref| from its own eager form, as with
  its jitted epilogues (ROADMAP section 3); in float32 the jitted
  reference is used;
* one train step: parameters with rtol 1e-3, atol 1.5 x 2 lr
  (tests/test_torch_train.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.configs import get_config as rget_config
from repro.models import build_model as rbuild
from repro.models import mlp as rmlp
from repro.sharding import ShardingCtx
from repro.training import AdamWConfig as RefAdamW
from repro.training import init_state as r_init_state
from repro.training import make_train_step as r_train_step
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import _tree_flatten_with_names
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.models import build_model, mlp
from repro_torch.models.model import _flat, param_shapes
from repro_torch.models.transformer import cast_tree
from repro_torch.training import AdamWConfig, init_state, make_train_step

ARCH = "granite-moe-1b-a400m"
F32_BAND, BF16_BAND, INIT_BAND, GATE_BAND = 1e-4, 3e-2, 2e-6, 1e-6
B, S = 2, 32
NO_DROP = 8.0          # capacity factor at which nothing drops (top-2 of 4)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _band(dtype):
    return F32_BAND if dtype == "float32" else BF16_BAND


def _cfg(dtype="float32", **kw):
    return reduce_cfg(rget_config(ARCH), dtype=dtype, **kw)


def _pair(dtype="float32", seed=0, **kw):
    cfg = _cfg(dtype, **kw)
    rm = rbuild(cfg, q_chunk=16, kv_chunk=16)
    rp = rm.init(jax.random.PRNGKey(seed))
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray, rp))
    pm = lm_params_from_reference(dataclasses.asdict(cfg),
                                  dict(zip(names, leaves)), device="cpu",
                                  q_chunk=16, kv_chunk=16)
    return rm, rp, pm


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _eager(dtype):
    """The reference's mode for ``dtype`` (see the module docstring)."""
    return jax.disable_jit() if dtype == "bfloat16" else _Nothing()


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _moe_layer(seed=0, **kw):
    """(cfg, the reference's layer-0 MoE params, the port's in float32)."""
    cfg = _cfg(**kw)
    rp = rbuild(cfg).init(jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda t: t[0], rp["layers"]["pos0"]["moe"])
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray, p))
    port: dict = {}
    for n, v in zip(names, leaves):
        *parents, leaf = n.split("/")
        node = port
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = torch.from_numpy(np.array(v))
    return cfg, p, port


def _x(n, d, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# -------------------------------------------------------------------- init
@pytest.mark.parametrize("shared", [0, 2])
def test_init_matches_reference_leaf_by_leaf(shared):
    cfg = _cfg(n_shared_experts=shared)
    rp = rbuild(cfg).init(jax.random.PRNGKey(3))
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray, rp))
    model = build_model(configs.ModelConfig(**dataclasses.asdict(cfg)),
                        device="cpu")
    port = _flat(model.init(3))
    assert sorted(port) == sorted(names)
    assert any("/moe/moe_gate" in n for n in names)
    assert any("/moe/shared/" in n for n in names) == bool(shared)
    for name, want in zip(names, leaves):
        got = port[name].numpy()
        assert got.shape == want.shape and got.dtype == np.float32, name
        assert _rel(got, want) <= INIT_BAND, name
    assert model.num_params() == cfg.num_params()
    assert param_shapes(cfg) == {n: tuple(v.shape) for n, v in
                                 zip(names, leaves)}


def test_full_config_counts():
    cfg = configs.get_config(ARCH)
    assert (cfg.family, cfg.n_experts, cfg.top_k, cfg.moe_d_ff) == \
        ("moe", 32, 8, 512)
    shapes = param_shapes(cfg)
    assert shapes["layers/pos0/moe/moe_gate"] == (24, 32, 1024, 512)
    assert shapes["layers/pos0/moe/router"] == (24, 1024, 32)
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg.num_params()
    # decode at batch 8 and the config's factor 1.25: two slots an expert
    assert mlp.capacity(cfg, 8) == 2
    assert mlp.capacity(cfg, 8, capacity_factor=float(cfg.n_experts)) == 64


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(dtype):
    cfg, p, port = _moe_layer()
    x = _x(256, cfg.d_model)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    gr, er = rmlp._route(jnp.asarray(x).astype(jd), p["router"], cfg.top_k)
    gp, ep = mlp._route(torch.from_numpy(x).to(td), port["router"],
                        cfg.top_k)
    assert ep.dtype == torch.int32 and gp.dtype == torch.float32
    # no exact tie, and no near-tie at the top-k boundary
    probs = torch.softmax(torch.from_numpy(x).to(td).float()
                          @ port["router"], -1)
    top = torch.sort(probs, -1, descending=True).values
    assert torch.all(top[:, :-1] > top[:, 1:])
    gap = (top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min().item()
    assert gap > GATE_BAND, gap
    np.testing.assert_array_equal(ep.numpy(), np.asarray(er))
    assert np.abs(gp.numpy() - np.asarray(gr)).max() <= GATE_BAND


def _ref_slots(eidx, e0, E_loc, C):
    """The reference's assignment positions (repro/models/mlp.py
    ``_expert_pass``, its first lines)."""
    flat_e = eidx.reshape(-1)
    e_rel = flat_e - e0
    in_slice = (e_rel >= 0) & (e_rel < E_loc)
    oh = jax.nn.one_hot(jnp.where(in_slice, e_rel, E_loc), E_loc + 1,
                        dtype=jnp.int32)[:, :E_loc]
    pos = jnp.cumsum(oh, axis=0) - oh
    pos = jnp.sum(pos * oh, axis=-1)
    keep = in_slice & (pos < C)
    return (np.asarray(keep), np.asarray(jnp.clip(e_rel, 0, E_loc - 1)),
            np.asarray(jnp.clip(pos, 0, C - 1)))


@pytest.mark.parametrize("factor", [0.5, NO_DROP])
def test_expert_pass_slots_and_output_match_reference(factor):
    cfg, p, port = _moe_layer(seed=1)
    T, E, K = 128, cfg.n_experts, cfg.top_k
    x = _x(T, cfg.d_model, seed=2)
    gates, eidx = rmlp._route(jnp.asarray(x), p["router"], K)
    C = mlp.capacity(cfg, T, factor)
    assert C == max(1, int(T * K * factor) // E)
    keep, e_safe, p_safe = mlp._slots(torch.from_numpy(np.asarray(eidx)), 0,
                                      E, C)
    want = _ref_slots(eidx, 0, E, C)
    for got, ref in zip((keep, e_safe, p_safe), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    dropped = 1.0 - keep.double().mean().item()
    assert (dropped > 0.3) if factor < 1 else dropped == 0.0
    # an expert slice ([1, 3) of 4): the other experts' assignments drop
    k2, _, p2 = mlp._slots(torch.from_numpy(np.asarray(eidx)), 1, 2, C)
    w2 = _ref_slots(eidx, 1, 2, C)
    np.testing.assert_array_equal(k2.numpy(), w2[0])
    np.testing.assert_array_equal(p2.numpy(), w2[2])
    want = rmlp._expert_pass(jnp.asarray(x), gates, eidx, p["moe_gate"],
                             p["moe_up"], p["moe_down"], 0, E, C)
    got = mlp._expert_pass(torch.from_numpy(x), torch.from_numpy(
        np.asarray(gates)), torch.from_numpy(np.asarray(eidx)),
        port["moe_gate"], port["moe_up"], port["moe_down"], 0, E, C)
    assert _rel(_np(got), _np(want)) <= F32_BAND


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(dtype, shared):
    cfg, p, port = _moe_layer(seed=2, n_shared_experts=shared)
    x = _x(B * S, cfg.d_model, seed=3).reshape(B, S, cfg.d_model)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    for factor in (None, 0.5):
        want = rmlp.moe_apply(cfg, ShardingCtx(), p,
                              jnp.asarray(x).astype(jd),
                              capacity_factor=factor)
        got = mlp.moe_apply(cfg, cast_tree(port, td),
                            torch.from_numpy(x).to(td),
                            capacity_factor=factor)
        assert got.dtype == td and tuple(got.shape) == x.shape
        assert _rel(_np(got), _np(want)) <= _band(dtype), factor


# ------------------------------------------------------------ whole decoder
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hidden_and_logits_match_reference(dtype):
    rm, rp, pm = _pair(dtype)
    toks = _tokens(pm.cfg.vocab, (B, S))
    batch = {"tokens": jnp.asarray(toks)}
    with _eager(dtype):
        h_ref = rm.hidden_seq(rp, batch, remat=False)
        lg_ref = rm.logits_seq(rp, batch)
    h = pm.hidden_seq({"tokens": toks})
    assert h.dtype == getattr(torch, dtype)
    assert _rel(_np(h), _np(h_ref)) <= _band(dtype)
    assert _rel(_np(pm.logits_seq({"tokens": toks})), _np(lg_ref)) \
        <= _band(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_caches_and_decode_logits(dtype):
    rm, rp, pm = _pair(dtype, seed=2)
    toks = _tokens(pm.cfg.vocab, (B, S + 1), seed=2)
    with _eager(dtype):
        lr, cr = rm.prefill(rp, {"tokens": jnp.asarray(toks[:, :S])}, S + 8)
        dr, _ = rm.decode(rp, jnp.asarray(toks[:, S:S + 1]), jnp.int32(S),
                          cr)
    lp, cp = pm.prefill({"tokens": toks[:, :S]}, S + 8)
    assert _rel(_np(lp), _np(lr)) <= _band(dtype)
    for i in range(2):
        assert _rel(_np(cp["pos0"][i]), _np(cr["pos0"][i])) <= _band(dtype)
    # decode: T = B tokens, C = int(2 * 2 * 1.25) // 4 = 1 slot an expert,
    # so assignments drop as in the reference
    assert mlp.capacity(pm.cfg, B) == 1
    dp, _ = pm.decode(toks[:, S:S + 1], S, cp)
    assert tuple(dp.shape) == (B, 1, pm.cfg.vocab)
    assert _rel(_np(dp), _np(dr)) <= _band(dtype)


def test_port_prefill_decode_matches_full_sequence_without_drops():
    """The reference's teacher-forcing test on the port, at a capacity
    factor that drops nothing (drops are a batch-level policy)."""
    cfg = reduce_cfg(configs.get_config(ARCH), moe_capacity_factor=NO_DROP)
    m = build_model(cfg, device="cpu", q_chunk=16, kv_chunk=16)
    m.init(2)
    toks = _tokens(cfg.vocab, (B, S + 1), seed=7)
    full = m.logits_seq({"tokens": toks}).float()
    _, caches = m.prefill({"tokens": toks[:, :S]}, cache_len=S + 4)
    lg, _ = m.decode(toks[:, S:S + 1], S, caches)
    np.testing.assert_allclose(lg[:, 0].float().numpy(), full[:, S].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_moe_train_step_matches_reference():
    rm, rp, pm = _pair(seed=4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rstate = {"params": rp, "opt": r_init_state(rp)}
    pstate = {"params": pm.params, "opt": init_state(pm.params)}
    rstep = jax.jit(r_train_step(rm, RefAdamW(**kw), loss_chunk=16))
    pstep = make_train_step(pm, AdamWConfig(**kw), loss_chunk=16)
    g = np.random.default_rng(8)
    for _ in range(2):
        batch = {"tokens": g.integers(0, pm.cfg.vocab, (4, S)).astype(
            np.int32), "labels": g.integers(0, pm.cfg.vocab, (4, S)).astype(
            np.int32)}
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        pstate, pmet = pstep(pstate, batch)
        assert abs(pmet["loss"].item() - float(rmet["loss"])) \
            <= F32_BAND * float(rmet["loss"])
    names, want, _ = _tree_flatten_with_names(
        jax.tree.map(np.asarray, rstate["params"]))
    got = _flat(pstate["params"])
    assert any("router" in n for n in names)
    for n, w in zip(names, want):
        np.testing.assert_allclose(got[n].numpy(), w, rtol=1e-3,
                                   atol=1.5 * 2 * kw["lr"], err_msg=n)
