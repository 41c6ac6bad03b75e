"""The port's LM training path (``repro_torch.training``, the training
forward of ``models``, ``data.ShardedBatcher``, ``launch.train``,
``convert.train_state_from_reference``) against the JAX package on the
CPU, at reduced configs (``conftest.reduce_cfg``) on numpy-seeded inputs.

Bands, fixed before the first comparison:

* ``schedule`` within 1e-6 relative at steps 0, 9, 50 and 100;
  ``apply_updates`` within 1e-6 of max|p| on random trees (``pow`` and
  ``sqrt`` may differ by an ulp between XLA-CPU and torch-CPU);
* ``chunked_softmax_xent``: value and gradient within 1e-5 relative;
* loss and every gradient leaf of reduced smollm within 1e-4 of max|g| in
  float32 compute, 3e-2 in bfloat16;
* one train step (and a ``microbatches=2`` step): parameters with rtol
  1e-3 and atol 1.5 x 2 lr, as ``tests/test_training.py`` compares
  post-Adam parameters (near-zero gradients give +-lr updates whose sign
  follows the summation order);
* exact: remat off, 'nothing' and 'dots' (bitwise loss and gradients),
  the batcher's integers, snapshots across packages leaf for leaf, a
  resume against the uninterrupted run.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as rget_config
from repro.data import ShardedBatcher as RefBatcher
from repro.models import build_model as rbuild
from repro.training import (AdamWConfig as RefAdamW, apply_updates as
                            r_apply, chunked_softmax_xent as r_xent,
                            init_state as r_init_state, make_loss_fn as
                            r_loss_fn, make_train_step as r_train_step,
                            schedule as r_schedule)
from repro.training.optimizer import global_norm as r_global_norm
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import (_tree_flatten_with_names,
                                                 _tree_unflatten)
from repro_torch.configs import get_config
from repro_torch.core.convert import (lm_params_from_reference,
                                      train_state_from_reference)
from repro_torch.data import ShardedBatcher, make_lm_tokens
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, apply_updates,
                                  chunked_softmax_xent, global_norm,
                                  init_state, init_train_state, make_loss_fn,
                                  make_train_step, schedule)

SCHED_BAND, UPD_BAND, XENT_BAND = 1e-6, 1e-6, 1e-5
F32_BAND, BF16_BAND = 1e-4, 3e-2
B, S = 4, 32


def _flat_np(tree) -> dict:
    """{leaf path: float64 numpy} of a torch or jax tree."""
    names, leaves, _ = _tree_flatten_with_names(tree)
    return {n: (x.detach().double().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(jnp.asarray(x).astype(jnp.float32),
                                np.float64))
            for n, x in zip(names, leaves)}


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _pair(arch="smollm-135m", dtype="float32", seed=0, **kw):
    """(reference model, its params, the port's model on those weights)."""
    cfg = reduce_cfg(rget_config(arch), dtype=dtype, **kw)
    rm = rbuild(cfg, q_chunk=16, kv_chunk=16)
    rp = rm.init(jax.random.PRNGKey(seed))
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray, rp))
    pm = lm_params_from_reference(dataclasses.asdict(cfg),
                                  dict(zip(names, leaves)), device="cpu",
                                  q_chunk=16, kv_chunk=16)
    return rm, rp, pm


def _batch(vocab, seed=0, b=B, s=S):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": g.integers(0, vocab, (b, s)).astype(np.int32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-4, warmup_steps=1, total_steps=37),
    dict(lr=1e-3, warmup_steps=40, total_steps=40, min_lr_ratio=0.0)])
def test_schedule_matches_reference(cfg):
    for step in (0, 9, 50, 100):
        want = float(r_schedule(RefAdamW(**cfg), jnp.int32(step)))
        got = schedule(AdamWConfig(**cfg), torch.tensor(step,
                                                        dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(got.item() - want) <= SCHED_BAND * abs(want), step
        assert schedule(AdamWConfig(**cfg), step).item() == got.item()


def _random_tree(g, scale=1.0):
    return {"w": (g.normal(size=(7, 5)) * scale).astype(np.float32),
            "b": (g.normal(size=(5,)) * scale).astype(np.float32),
            "blk": {"k": (g.normal(size=(2, 3, 4)) * scale).astype(
                np.float32), "s": (g.normal(size=(3,)) * scale).astype(
                np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_apply_updates_matches_reference_on_random_trees(clip):
    g = np.random.default_rng(4)
    kw = dict(lr=0.05, warmup_steps=2, total_steps=20, clip_norm=clip)
    rcfg, pcfg = RefAdamW(**kw), AdamWConfig(**kw)
    p0 = _random_tree(g)
    rp = jax.tree.map(jnp.asarray, p0)
    pp = _to_torch(p0)
    rs, ps = r_init_state(rp), init_state(pp)
    assert ps["step"].dtype == torch.int32
    for i in range(5):
        grads = _random_tree(g, scale=3.0)
        rp, rs, rmet = r_apply(rcfg, rp, jax.tree.map(jnp.asarray, grads),
                               rs)
        pp, ps, pmet = apply_updates(pcfg, pp, _to_torch(grads), ps)
        want, got = _flat_np(rp), _flat_np(pp)
        assert sorted(want) == sorted(got)
        top = max(np.abs(v).max() for v in want.values())
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= UPD_BAND * top, (i, k)
        for part in ("m", "v"):
            w, p = _flat_np(rs[part]), _flat_np(ps[part])
            for k in w:
                assert _rel(p[k], w[k]) <= UPD_BAND, (i, part, k)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        assert abs(pmet["grad_norm"].item() - float(rmet["grad_norm"])) \
            <= UPD_BAND * float(rmet["grad_norm"])
        assert abs(pmet["lr"].item() - float(rmet["lr"])) \
            <= SCHED_BAND * float(rmet["lr"])


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=300,
                      weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = init_state(params)
    for _ in range(300):
        params, state, _ = apply_updates(
            cfg, params, {"w": 2 * (params["w"] - target)}, state)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(schedule(cfg, 0)) < 0.2
    np.testing.assert_allclose(float(schedule(cfg, 9)), 1.0, rtol=0.01)
    assert abs(float(schedule(cfg, 100)) - 0.1) < 1e-3


def test_grad_clipping():
    cfg = AdamWConfig(lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = apply_updates(cfg, params, g, init_state(params))
    assert float(metrics["grad_norm"]) == 200.0
    assert float(global_norm(g)) == 200.0
    assert float(global_norm(g)) == float(r_global_norm(
        {"w": jnp.full((4,), 100.0)}))


def test_weight_decay_on_matrices_only():
    """Decoupled decay touches ndim >= 2 leaves; a zero gradient leaves a
    vector as it is and shrinks a matrix by lr * wd * p."""
    cfg = AdamWConfig(lr=0.5, warmup_steps=1, total_steps=10,
                      weight_decay=0.1)
    params = {"v": torch.ones(3), "m": torch.ones(2, 2)}
    zero = {"v": torch.zeros(3), "m": torch.zeros(2, 2)}
    new, _, met = apply_updates(cfg, params, zero, init_state(params))
    assert torch.equal(new["v"], params["v"])
    lr = met["lr"]
    assert torch.equal(new["m"], params["m"] - lr * (0.1 * params["m"]))


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_xent_value_and_grad_match_reference(chunk, z_loss):
    g = np.random.default_rng(1)
    h = g.normal(size=(2, 32, 16)).astype(np.float32)
    w = g.normal(size=(50, 16)).astype(np.float32)
    lab = g.integers(0, 50, (2, 32)).astype(np.int32)

    def rfn(h_, w_):
        return r_xent(h_, w_, jnp.asarray(lab), chunk=chunk, z_loss=z_loss)
    rv, (rgh, rgw) = jax.value_and_grad(rfn, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    v = chunked_softmax_xent(th, tw, torch.from_numpy(lab), chunk=chunk,
                             z_loss=z_loss)
    gh, gw = torch.autograd.grad(v, (th, tw))
    assert abs(v.item() - float(rv)) <= XENT_BAND * abs(float(rv))
    assert _rel(gh.numpy(), np.asarray(rgh)) <= XENT_BAND
    assert _rel(gw.numpy(), np.asarray(rgw)) <= XENT_BAND
    # and the dense form of the same mean
    logits = torch.from_numpy(h) @ torch.from_numpy(w).T
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, torch.from_numpy(lab).long()[..., None])
    want = (lse - gold[..., 0]).mean() + z_loss * (lse ** 2).mean()
    np.testing.assert_allclose(v.item(), want.item(), rtol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        chunked_softmax_xent(th, tw, torch.from_numpy(lab), chunk=12)


def _port_value_and_grad(pm, batch, **kw):
    names, leaves, td = _tree_flatten_with_names(pm.params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    loss = make_loss_fn(pm, loss_chunk=16, **kw)(_tree_unflatten(td, xs),
                                                 batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, xs)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    rm, rp, pm = _pair(dtype=dtype, seed=1)
    batch = _batch(pm.cfg.vocab, seed=1)
    rl, rg = jax.value_and_grad(r_loss_fn(rm, loss_chunk=16))(
        rp, _jbatch(batch))
    loss, grads = _port_value_and_grad(pm, batch)
    band = F32_BAND if dtype == "float32" else BF16_BAND
    assert abs(loss.item() - float(rl)) <= band * abs(float(rl))
    want = _flat_np(rg)
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        assert _rel(g.numpy(), want[name]) <= band, name


def test_remat_policies_are_bitwise_equal():
    cfg = reduce_cfg(get_config("smollm-135m"))
    batch = _batch(cfg.vocab, seed=2)
    out = []
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        m = build_model(cfg, "cpu", q_chunk=8, kv_chunk=8,
                        remat_policy=policy)
        m.init(2)
        out.append(_port_value_and_grad(m, batch, remat=remat))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(g, out[0][1][k]) for k, g in grads.items())
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(cfg, "cpu", remat_policy="everything")


def test_dots_policy_keeps_the_products():
    """Under 'dots' the backward pass recomputes no matrix product of a
    period (only the attention block's own checkpoint recomputes its
    two, as without remat); under 'nothing' it recomputes them all."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    cfg = reduce_cfg(get_config("smollm-135m"))
    batch = _batch(cfg.vocab, seed=2)
    counts = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        m = build_model(cfg, "cpu", q_chunk=32, kv_chunk=32,
                        remat_policy=policy)
        m.init(2)
        Count.n = 0
        with Count():
            _port_value_and_grad(m, batch, remat=remat)
        counts[(remat, policy)] = Count.n
    plain = counts[(False, "nothing")]
    assert counts[(True, "nothing")] > plain
    assert counts[(True, "dots")] == plain


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    rm, rp, pm = _pair(seed=3)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rstep = jax.jit(r_train_step(rm, RefAdamW(**kw), loss_chunk=16,
                                 microbatches=microbatches))
    pstep = make_train_step(pm, AdamWConfig(**kw), loss_chunk=16,
                            microbatches=microbatches)
    rstate = {"params": rp, "opt": r_init_state(rp)}
    pstate = {"params": pm.params, "opt": init_state(pm.params)}
    for i in range(2):
        batch = _batch(pm.cfg.vocab, seed=10 + i)
        rstate, rmet = rstep(rstate, _jbatch(batch))
        pstate, pmet = pstep(pstate, batch)
        assert abs(pmet["loss"].item() - float(rmet["loss"])) \
            <= F32_BAND * float(rmet["loss"])
        want, got = _flat_np(rstate["params"]), _flat_np(pstate["params"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1.5 * 2 * kw["lr"], err_msg=k)
    assert int(pstate["opt"]["step"]) == 2
    # the model now serves the trained weights
    assert all(a is b for a, b in zip(
        _tree_flatten_with_names(pm.params)[1],
        _tree_flatten_with_names(pstate["params"])[1]))


def test_microbatch_equivalence():
    cfg = reduce_cfg(get_config("smollm-135m"), n_layers=2)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(cfg.vocab, seed=5)
    out = []
    for mb in (1, 2):
        m = build_model(cfg, "cpu", q_chunk=16, kv_chunk=16)
        state = init_train_state(m, 0)
        state, met = make_train_step(m, AdamWConfig(**kw), loss_chunk=16,
                                     microbatches=mb)(state, batch)
        out.append((met, _flat_np(state["params"])))
    np.testing.assert_allclose(out[0][0]["loss"].item(),
                               out[1][0]["loss"].item(), rtol=1e-5)
    for k in out[0][1]:
        np.testing.assert_allclose(out[0][1][k], out[1][1][k], rtol=1e-3,
                                   atol=1.5 * 2 * kw["lr"], err_msg=k)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(m, AdamWConfig(), loss_chunk=16, microbatches=3)(
            state, batch)


def test_training_refreshes_the_served_weights():
    cfg = reduce_cfg(get_config("smollm-135m"))
    m = build_model(cfg, "cpu", q_chunk=16, kv_chunk=16)
    state = init_train_state(m, 1)
    toks = _batch(cfg.vocab, seed=6)
    before = m.prefill({"tokens": toks["tokens"]}, S + 2)[0]
    cast = m.compute_params
    state, _ = make_train_step(m, AdamWConfig(lr=1e-2, warmup_steps=1),
                               loss_chunk=16)(state, toks)
    after = m.prefill({"tokens": toks["tokens"]}, S + 2)[0]
    assert m.compute_params is not cast
    assert not torch.equal(before, after)
    fresh = build_model(cfg, "cpu", q_chunk=16, kv_chunk=16)
    fresh.load_params(state["params"])
    assert torch.equal(after, fresh.prefill({"tokens": toks["tokens"]},
                                            S + 2)[0])


def test_train_loss_falls_on_token_stream():
    cfg = reduce_cfg(get_config("smollm-135m"))
    m = build_model(cfg, "cpu", q_chunk=16, kv_chunk=16)
    state = init_train_state(m, 0)
    step = make_train_step(m, AdamWConfig(lr=3e-3, warmup_steps=2,
                                          total_steps=30), loss_chunk=16)
    stream = make_lm_tokens(8 * 4 * (S + 1) + 1, cfg.vocab, seed=0)
    it = iter(ShardedBatcher(stream, 4, S, device="cpu"))
    losses = []
    for _ in range(8):
        tok, lab = next(it)
        state, met = step(state, {"tokens": tok, "labels": lab})
        losses.append(met["loss"].item())
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ----------------------------------------------------------------- batcher
def test_sharded_batcher_matches_reference_with_seek():
    stream = make_lm_tokens(5000, 256, seed=3)
    ref = RefBatcher(stream, 4, 16, seed=7)
    port = ShardedBatcher(stream, 4, 16, seed=7, device="cpu")
    ri, pi = iter(ref), iter(port)
    for _ in range(3):
        (rt, rl), (pt, pl) = next(ri), next(pi)
        assert pt.dtype == pl.dtype == torch.int32
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    ref.seek(40)          # mid-iteration: prefetched batches go stale
    port.seek(40)
    for _ in range(4):
        (rt, rl), (pt, pl) = next(ri), next(pi)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    assert port.step == ref.step == 44
    fresh = ShardedBatcher(stream, 4, 16, seed=7, device="cpu")
    fresh.seek(44)
    np.testing.assert_array_equal(next(iter(fresh))[0].numpy(),
                                  np.asarray(next(ri)[0]))
    # a mesh is a DeviceMesh with named axes (tests/test_torch_mesh.py
    # places batches on one)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ShardedBatcher(stream, 4, 16, mesh=object())


# ----------------------------------------------------------------- restore
def _train(model, state, batches, kw):
    step = make_train_step(model, AdamWConfig(**kw), loss_chunk=16)
    for b in batches:
        state, _ = step(state, b)
    return state


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    cfg = reduce_cfg(get_config("granite-moe-1b-a400m"))
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=6)
    stream = make_lm_tokens(6 * 2 * (S + 1) + 1, cfg.vocab, seed=4)

    def batches(start, n):
        b = ShardedBatcher(stream, 2, S, device="cpu")
        b.seek(start)
        it = iter(b)
        return [dict(zip(("tokens", "labels"), next(it)))
                for _ in range(n)]

    m = build_model(cfg, "cpu", q_chunk=16, kv_chunk=16)
    whole = _train(m, init_train_state(m, 0), batches(0, 6), kw)

    m1 = build_model(cfg, "cpu", q_chunk=16, kv_chunk=16)
    half = _train(m1, init_train_state(m1, 0), batches(0, 3), kw)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, half, blocking=True)
    del m1, half
    m2 = build_model(cfg, "cpu", q_chunk=16, kv_chunk=16)
    like = init_train_state(m2, 5)
    state = ck.restore(like, device="cpu")
    m2.use_params(state["params"])
    state["params"] = m2.params
    assert ck.latest_step() == 3
    resumed = _train(m2, state, batches(ck.latest_step(), 3), kw)
    a, b = _tree_flatten_with_names(whole), _tree_flatten_with_names(resumed)
    assert a[0] == b[0]
    for name, x, y in zip(a[0], a[1], b[1]):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _ref_state_flat(state) -> dict:
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray,
                                                             state))
    return dict(zip(names, leaves))


def test_train_snapshots_cross_packages(tmp_path):
    rm, rp, pm = _pair(seed=4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rstate = {"params": rp, "opt": r_init_state(rp)}
    rstate, _ = jax.jit(r_train_step(rm, RefAdamW(**kw), loss_chunk=16))(
        rstate, _jbatch(_batch(pm.cfg.vocab, seed=20)))
    # reference -> port, through its Checkpointer
    RefCheckpointer(str(tmp_path / "ref")).save(1, rstate, blocking=True)
    ck = Checkpointer(str(tmp_path / "ref"))
    like = init_train_state(build_model(pm.cfg, "cpu"), 0)
    got = ck.restore(like, device="cpu")
    want = _ref_state_flat(rstate)
    names, leaves, _ = _tree_flatten_with_names(got)
    assert sorted(names) == sorted(want)
    for n, x in zip(names, leaves):
        assert x.numpy().dtype == want[n].dtype, n
        np.testing.assert_array_equal(x.numpy(), want[n], err_msg=n)
    # the converter gives the same state
    model, conv = train_state_from_reference(dataclasses.asdict(pm.cfg),
                                             want, device="cpu")
    cn, cl, _ = _tree_flatten_with_names(conv)
    assert cn == names and all(torch.equal(a, b) for a, b in zip(cl, leaves))
    assert conv["opt"]["step"].dtype == torch.int32
    # port -> reference: a step on, then restored by the reference
    conv, _ = make_train_step(model, AdamWConfig(**kw), loss_chunk=16)(
        conv, _batch(pm.cfg.vocab, seed=21))
    Checkpointer(str(tmp_path / "port")).save(2, conv, blocking=True)
    back = RefCheckpointer(str(tmp_path / "port")).restore(rstate)
    back = _ref_state_flat(back)
    mine = {n: x.numpy() for n, x in zip(
        *_tree_flatten_with_names(conv)[:2])}
    assert sorted(back) == sorted(mine)
    for n in back:
        assert back[n].dtype == mine[n].dtype, n
        np.testing.assert_array_equal(back[n], mine[n], err_msg=n)
    with pytest.raises(ValueError, match="opt/step"):
        train_state_from_reference(dataclasses.asdict(pm.cfg), {
            k: v for k, v in want.items() if k != "opt/step"}, device="cpu")


# --------------------------------------------------------------------- CLI
def test_train_cli_tiny(capsys, tmp_path):
    args = ["--preset", "tiny", "--device", "cpu", "--steps", "24",
            "--batch", "4", "--seq", "64", "--log-every", "100"]
    assert train_cli.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["last_loss"] < out["first_loss"]
    assert out["monitor"]["steps"] == 24
    # restore on start: a run to step 4 continues to 6 where it left off
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    small = ["--arch", "granite-moe-1b-a400m", "--preset", "tiny",
             "--device", "cpu", "--batch", "2", "--seq", "32"]
    assert train_cli.main(small + ck + ["--steps", "4"]) == 0
    capsys.readouterr()
    assert train_cli.main(small + ck + ["--steps", "6"]) == 0
    text = capsys.readouterr().out
    assert "restored checkpoint at step 4" in text
    assert json.loads(text.strip().splitlines()[-1])["monitor"]["steps"] \
        == 2


@pytest.mark.parametrize("flags,exc,match", [
    # a mesh needs its ranks: one process a rank in a process group
    # (tests/test_torch_mesh.py trains on four); the ids are the ones
    # these cases had when the CLI refused a mesh outright
    pytest.param(["--mesh", "2x2"], RuntimeError, "process group",
                 id="flags0-13d"),
    pytest.param(["--mesh", "production", "--multi-pod"], RuntimeError,
                 "process group", id="flags1-13d"),
    pytest.param(["--host-devices", "8"], NotImplementedError,
                 "no counterpart", id="flags2-no counterpart")])
def test_train_cli_refusals(flags, exc, match):
    with pytest.raises(exc, match=match):
        train_cli.main(["--device", "cpu", *flags])
    # the VLM's batch is embeddings; the trainer feeds tokens, as the
    # reference's does (whose model then raises KeyError: 'embeds')
    with pytest.raises(NotImplementedError, match="embeds"):
        train_cli.main(["--arch", "qwen2-vl-72b", "--device", "cpu",
                        "--steps", "1"])


def test_train_cli_whisper(capsys):
    """The encoder-decoder trains through the CLI on zero frames, as the
    reference's trainer feeds it."""
    assert train_cli.main(["--arch", "whisper-small", "--preset", "tiny",
                           "--device", "cpu", "--steps", "3", "--batch",
                           "2", "--seq", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
