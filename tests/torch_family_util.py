"""Checks shared by the per-family comparisons of the port's models
against the JAX package on the CPU (tests/test_torch_mla.py,
test_torch_mamba.py, test_torch_xlstm.py, test_torch_vlm.py,
test_torch_encdec.py). Each test file states its bands; these helpers
take them as arguments.

Every check runs a reduced config (``conftest.reduce_cfg``) with
``q_chunk = kv_chunk = 16`` and ``ssm_chunk = 8`` on numpy-seeded inputs:
tokens, or a family's batch (``batch_fn(vocab, seed, n)``: the VLM's
embeds and positions, the encoder-decoder's frames and tokens).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as rget_config
from repro.models import build_model as rbuild
from repro.training import AdamWConfig as RefAdamW
from repro.training import init_state as r_init_state
from repro.training import make_train_step as r_train_step
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import (_tree_flatten_with_names,
                                                 _tree_unflatten)
from repro_torch.core.convert import (lm_params_from_reference,
                                      train_state_from_reference)
from repro_torch.models import build_model
from repro_torch.models.model import _flat, param_shapes  # noqa: F401
from repro_torch.training import (AdamWConfig, init_state, init_train_state,
                                  make_loss_fn, make_train_step)

B, S = 2, 32
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=8)
NO_DROP = 8.0      # a capacity factor at which the reduced MoEs drop nothing


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops one thread each while a family file runs: the
    sLSTM loop and the small decode ops gain nothing from a thread pool,
    and beside other test processes an oversubscribed pool slows them
    tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def as_np(x):
    """A torch or jax array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def flat_np(tree) -> dict:
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray,
                                                             tree))
    return dict(zip(names, leaves))


def cfg_of(arch, dtype="float32", **kw):
    return reduce_cfg(rget_config(arch), dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, seed, kw: tuple):
    """The reference model and its (immutable) params, drawn once a
    process for each config and seed."""
    rm = rbuild(cfg_of(arch, dtype, **dict(kw)), **CHUNKS)
    return rm, rm.init(jax.random.PRNGKey(seed))


def pair(arch, dtype="float32", seed=0, **kw):
    """(reference model, its params, a fresh port model holding them)."""
    rm, rp = _reference(arch, dtype, seed, tuple(sorted(kw.items())))
    pm = lm_params_from_reference(dataclasses.asdict(rm.cfg), flat_np(rp),
                                  device="cpu", **CHUNKS)
    return rm, rp, pm


@functools.lru_cache(maxsize=None)
def _reference_step(arch, lr):
    """The reference's jitted train step (compiled once a process)."""
    rm, _ = _reference(arch, "float32", 4, ())
    return jax.jit(r_train_step(rm, RefAdamW(lr=lr, warmup_steps=1,
                                             total_steps=10),
                                loss_chunk=16))


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def reference_mode(cfg):
    """The reference run eagerly for a bfloat16 MoE (under ``jit`` XLA
    rounds bfloat16 elsewhere, and where that moves a route the jitted
    reference strays from its own eager form: tests/test_torch_moe.py),
    as it is otherwise."""
    if cfg.dtype == "bfloat16" and cfg.n_experts:
        return jax.disable_jit()
    return _Nothing()


# ------------------------------------------------------------------- init
def check_init(arch, exact: set, band: float, seed=3, **kw):
    """``init(seed)`` leaf by leaf: the leaves named in ``exact`` (drawn
    by exact ops: ones, zeros, constants) and the norm scales bitwise,
    the others within ``band`` of max|leaf|. Returns the leaf names."""
    cfg = cfg_of(arch, **kw)
    want = flat_np(rbuild(cfg).init(jax.random.PRNGKey(seed)))
    model = build_model(configs.ModelConfig(**dataclasses.asdict(cfg)),
                        device="cpu")
    got = {k: v.numpy() for k, v in _flat(model.init(seed)).items()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == np.float32, name
        if name.split("/")[-1] in exact or "norm" in name:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert rel(g, w) <= band, name
    assert param_shapes(cfg) == {n: w.shape for n, w in want.items()}
    return sorted(want)


def check_full_shapes(arch, total: int):
    """``param_shapes`` of the full config against the reference's
    ``jax.eval_shape`` of ``Model.init``, leaf for leaf."""
    cfg = rget_config(arch)
    names, leaves, _ = _tree_flatten_with_names(
        jax.eval_shape(rbuild(cfg).init, jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in zip(names, leaves)}
    got = param_shapes(configs.get_config(arch))
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == total
    return cfg


# ------------------------------------------------------------ the decoder
def _close(got, want, band, what=""):
    """``got`` within ``band`` of max|want| (an all-zero or all-one state
    leaf, as sLSTM's n or a Mamba conv window start, exactly)."""
    want = as_np(want)
    assert tuple(got.shape) == want.shape, what
    if np.abs(want).max() == 0:
        assert not got.any(), what
        return 0.0
    d = rel(as_np(got), want)
    assert d <= band, (what, d)
    return d


def check_hidden_and_logits(arch, band):
    """Float32 hidden states and logits against the reference's."""
    rm, rp, pm = pair(arch)
    toks = tokens(pm.cfg.vocab, (B, S))
    h_r = rm.hidden_seq(rp, {"tokens": jnp.asarray(toks)}, remat=False)
    h = pm.hidden_seq({"tokens": toks})
    assert h.dtype == torch.float32
    _close(h, h_r, band, "hidden")
    lg_r = jnp.einsum("bsd,vd->bsv", h_r, rm.unembed(rp).astype(h_r.dtype))
    _close(pm.logits_seq({"tokens": toks}), lg_r, band, "logits")


def check_prefill_and_decode(arch, band, seed=2):
    """Float32 prefill (last logits, every cache or state leaf) and two
    decode steps (logits, every leaf after them) against the
    reference's."""
    rm, rp, pm = pair(arch, seed=seed)
    toks = tokens(pm.cfg.vocab, (B, S + 2), seed=seed)
    lr, cr = rm.prefill(rp, {"tokens": jnp.asarray(toks[:, :S])}, S + 8)
    lp, cp = pm.prefill({"tokens": toks[:, :S]}, S + 8)
    _close(lp, lr, band, "prefill logits")
    for a, b in zip(_tree_flatten_with_names(cp)[1], jax.tree.leaves(cr)):
        _close(a, b, band, "prefill cache")
    for i in range(2):
        dr, cr = rm.decode(rp, jnp.asarray(toks[:, S + i:S + i + 1]),
                           jnp.int32(S + i), cr)
        dp, cp = pm.decode(toks[:, S + i:S + i + 1], S + i, cp)
        assert tuple(dp.shape) == (B, 1, pm.cfg.vocab)
        _close(dp, dr, band, f"decode {i}")
    names, leaves, _ = _tree_flatten_with_names(cp)
    assert len(leaves) == len(jax.tree.leaves(cr))
    for n, a, b in zip(names, leaves, jax.tree.leaves(cr)):
        _close(a, b, band, n)


class _Record:
    """Records the reference's calls of ``transformer.<name>`` (run
    eagerly, so every argument and result is concrete)."""

    def __init__(self, name):
        from repro.models import transformer as rtfm
        self.mod, self.name, self.calls = rtfm, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.mod, self.name)

        def rec(*a, **kw):
            out = orig(*a, **kw)
            self.calls.append((a, out))
            return out
        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *a):
        setattr(self.mod, self.name, self.orig)
        return False


def _torch_tree(t, dtype=None):
    if isinstance(t, dict):
        return {k: _torch_tree(v, dtype) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_torch_tree(v, dtype) for v in t)
    x = torch.from_numpy(np.array(jnp.asarray(t).astype(jnp.float32)))
    return x if dtype is None else x.to(dtype)


class RefRoutes:
    """Records the expert ids of the reference's ``mlp._route`` calls
    (run eagerly, so the ids are concrete)."""

    def __enter__(self):
        from repro.models import mlp as rmlp
        self.mlp, self.orig, self.ids = rmlp, rmlp._route, []

        def route(*a):
            gates, eidx = self.orig(*a)
            self.ids.append(torch.from_numpy(np.array(eidx)))
            return gates, eidx
        rmlp._route = route
        return self

    def __exit__(self, *a):
        self.mlp._route = self.orig
        return False


def check_blocks_bfloat16(arch, band, seed=2, prefill_batch=None, **kw):
    """bfloat16, block by block: the reference runs prefill of S tokens
    and two decode steps eagerly, recording each block's call (its
    float32 parameter slice, input, cache) and result, and each MoE's
    expert ids; the port's block, on its serving copy of that slice
    (``cast_tree``), the same input and cache and the reference's expert
    ids (a last-bit difference in the float32 router flips a top-k
    choice at a near-tie), gives the output and the cache or state within
    ``band`` of max|ref|. Then the final norm and logits from the
    reference's last hidden state. ``prefill_batch`` (numpy) replaces the
    prompt's tokens (the VLM's embeds and positions); each block takes
    the positions the reference's did. Returns the largest distance."""
    from repro_torch.models import transformer as tfm
    rm, rp, pm = pair(arch, "bfloat16", seed=seed, **kw)
    cfg = pm.cfg
    bf = torch.bfloat16
    toks = tokens(cfg.vocab, (B, S + 2), seed=seed)
    with jax.disable_jit(), _Record("apply_block_prefill") as pre, \
            _Record("apply_block_decode") as dec, RefRoutes() as routes:
        prompt = ({"tokens": toks[:, :S]} if prefill_batch is None
                  else prefill_batch)
        lr, cr = rm.prefill(rp, {k: jnp.asarray(v) for k, v in
                                 prompt.items()}, S + 8)
        for i in range(2):
            rm.decode(rp, jnp.asarray(toks[:, S + i:S + i + 1]),
                      jnp.int32(S + i), cr)
    assert len(pre.calls) == cfg.n_layers == len(dec.calls) // 2
    worst = 0.0
    with RouteTape(lambda i: routes.ids[i]) as tape:
        for (a, (h_r, c_r)) in pre.calls:
            _, _, p, j, h, positions = a[:6]
            positions = torch.from_numpy(np.array(positions)).long()
            h_p, c_p = tfm.apply_block_prefill(
                cfg, tfm.cast_tree(_torch_tree(p), bf), j,
                _torch_tree(h, bf), positions, S + 8, q_chunk=16,
                kv_chunk=16, ssm_chunk=8)
            assert h_p.dtype == bf
            worst = max(worst, _close(h_p, h_r, band, f"prefill block {j}"))
            for x, y in zip(_tree_flatten_with_names(c_p)[1],
                            jax.tree.leaves(c_r)):
                worst = max(worst, _close(x, y, band, f"prefill cache {j}"))
        for (a, (h_r, c_r)) in dec.calls:
            _, _, p, j, h, pos, cache = a
            # the cache keeps its own dtype (bfloat16 rows, float32 states)
            c_in = jax.tree.map(
                lambda x, r: x.to(getattr(torch, str(r.dtype))),
                _torch_tree(cache), cache)
            h_p, c_p = tfm.apply_block_decode(
                cfg, tfm.cast_tree(_torch_tree(p), bf), j,
                _torch_tree(h, bf), int(pos), c_in)
            worst = max(worst, _close(h_p, h_r, band, f"decode block {j}"))
            for x, y in zip(_tree_flatten_with_names(c_p)[1],
                            jax.tree.leaves(c_r)):
                worst = max(worst, _close(x, y, band, f"decode state {j}"))
    assert len(tape.ids) == len(routes.ids)
    last = _torch_tree(pre.calls[-1][1][0], bf)
    lg = tfm.rms_norm(last, pm.compute_params["final_norm"],
                      cfg.norm_eps)[:, -1] @ pm._unembed_c().T
    return max(worst, _close(lg, lr, band, "logits"))


class RouteTape:
    """Records the expert ids of each ``mlp._route`` call inside the
    block, or replays them (``replay(i)`` the ids for call i), with gates
    from the model's own float32 router probabilities at those ids."""

    def __init__(self, replay=None):
        self.replay, self.ids = replay, []

    def __enter__(self):
        from repro_torch.models import mlp
        self.mlp, self.orig = mlp, mlp._route

        def route(x2d, router_w, top_k):
            if self.replay is None:
                gates, eidx = self.orig(x2d, router_w, top_k)
            else:
                eidx = self.replay(len(self.ids))
                probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
                gates = torch.gather(probs, 1, eidx.long())
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            self.ids.append(eidx)
            return gates, eidx
        mlp._route = route
        return self

    def __exit__(self, *a):
        self.mlp._route = self.orig
        return False


def teacher_forcing(arch, dtype="bfloat16", seed=2, **kw):
    """prefill(S) then decode token S against the full sequence's logits
    at S, at a capacity factor that drops nothing (the reference's
    tests/test_models_smoke.py), rtol = atol = 2e-2. A bfloat16 MoE is
    held with the full sequence's routes replayed (a rounding flips a
    top-k choice at a near-tie); its free distance is returned too.
    Returns (held or free max |d| / max |full|, free)."""
    cfg = reduce_cfg(configs.get_config(arch), dtype=dtype,
                     moe_capacity_factor=NO_DROP, **kw)
    m = build_model(cfg, device="cpu", **CHUNKS)
    m.init(seed)
    toks = tokens(cfg.vocab, (B, S + 1), seed=7)
    with RouteTape() as tape:
        full = m.logits_seq({"tokens": toks}).float()
    want = full[:, S].numpy()

    def run(replay):
        pre = dec = None
        if replay:
            ids = [e.reshape(B, S + 1, -1) for e in tape.ids]
            pre = lambda i: ids[i][:, :S].reshape(B * S, -1)  # noqa: E731
            dec = lambda i: ids[i][:, S]                      # noqa: E731
        with RouteTape(pre):
            _, caches = m.prefill({"tokens": toks[:, :S]}, cache_len=S + 4)
        with RouteTape(dec):
            lg, _ = m.decode(toks[:, S:S + 1], S, caches)
        return lg[:, 0].float().numpy()
    free = run(False)
    got = run(True) if (cfg.n_experts and dtype == "bfloat16") else free
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    return rel(got, want), rel(free, want)


# --------------------------------------------------------------- training
def _batch(vocab, seed, n=4):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, vocab, (n, S)).astype(np.int32),
            "labels": g.integers(0, vocab, (n, S)).astype(np.int32)}


def check_train_step(arch, band, lr=1e-3, batch_fn=None):
    """Two AdamW steps in float32 against the reference's: losses within
    ``band`` relative, parameters with rtol 1e-3 and atol 1.5 x 2 lr
    (tests/test_training.py)."""
    batch_fn = batch_fn or _batch
    _, rp, pm = pair(arch, seed=4)
    okw = dict(lr=lr, warmup_steps=1, total_steps=10)
    rstate = {"params": rp, "opt": r_init_state(rp)}
    pstate = {"params": pm.params, "opt": init_state(pm.params)}
    rstep = _reference_step(arch, lr)
    pstep = make_train_step(pm, AdamWConfig(**okw), loss_chunk=16)
    for i in range(2):
        batch = batch_fn(pm.cfg.vocab, seed=8 + i)
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        pstate, pmet = pstep(pstate, batch)
        assert abs(pmet["loss"].item() - float(rmet["loss"])) \
            <= band * float(rmet["loss"])
    want, got = flat_np(rstate["params"]), _flat(pstate["params"])
    assert sorted(want) == sorted(got)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w, rtol=1e-3,
                                   atol=1.5 * 2 * lr, err_msg=n)
    return sorted(want)


def check_grads(arch, band, batch, seed=4, zero=()):
    """The loss and every gradient leaf of one float32 batch against the
    reference's (``jax.value_and_grad`` of its loss), each leaf within
    ``band`` of its own max|ref| (a leaf the batch does not reach, as the
    VLM's embed table, zero in both). The leaves named in ``zero`` have
    an exactly zero gradient whose rounding noise both packages hold
    within ``band`` of the largest gradient of the tree. Returns {leaf:
    distance}."""
    from repro.training.train_step import make_loss_fn as r_loss_fn
    rm, rp, pm = pair(arch, seed=seed)
    loss_r, g_r = jax.value_and_grad(r_loss_fn(rm, loss_chunk=16))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    names, leaves, td = _tree_flatten_with_names(pm.params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    loss = make_loss_fn(pm, loss_chunk=16)(_tree_unflatten(td, xs), batch)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    assert abs(loss.item() - float(loss_r)) <= band * abs(float(loss_r))
    want, out = flat_np(g_r), {}
    assert sorted(want) == sorted(names)
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, x, g in zip(names, xs, grads):
        g = torch.zeros_like(x) if g is None else g
        if n in zero:
            out[n] = max(float(g.abs().max()), float(np.abs(want[n]).max())
                         ) / top
            assert out[n] <= band, (n, out[n])
        else:
            out[n] = _close(g, want[n], band, n)
    return out


def check_remat_bitwise(arch, batch_fn=None, **kw):
    """The loss and every gradient leaf equal bit for bit with remat off,
    'nothing' and 'dots'."""
    cfg = reduce_cfg(configs.get_config(arch), dtype="float32", **kw)
    batch = (batch_fn or _batch)(cfg.vocab, seed=2, n=2)
    out = []
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        m = build_model(cfg, "cpu", remat_policy=policy, **CHUNKS)
        m.init(2)
        names, leaves, td = _tree_flatten_with_names(m.params)
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss = make_loss_fn(m, loss_chunk=16, remat=remat)(
            _tree_unflatten(td, xs), batch)
        out.append((loss.detach(), torch.autograd.grad(loss, xs)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(g, h) for g, h in zip(grads, out[0][1]))
    assert all(bool(torch.isfinite(g).all()) for g in out[0][1])


def check_snapshot_crossing(arch, tmp_path, lr=1e-3, batch_fn=None):
    """A reference train state saved by its Checkpointer is restored by
    the port's bitwise (and by ``train_state_from_reference``); a port
    state one step on is restored by the reference's bitwise."""
    batch_fn = batch_fn or _batch
    _, rp, pm = pair(arch, seed=4)
    okw = dict(lr=lr, warmup_steps=1, total_steps=10)
    rstate = {"params": rp, "opt": r_init_state(rp)}
    rstate, _ = _reference_step(arch, lr)(
        rstate, {k: jnp.asarray(v) for k, v in
                 batch_fn(pm.cfg.vocab, seed=20).items()})
    RefCheckpointer(str(tmp_path / "ref")).save(1, rstate, blocking=True)
    got = Checkpointer(str(tmp_path / "ref")).restore(
        init_train_state(build_model(pm.cfg, "cpu", **CHUNKS), 0),
        device="cpu")
    want = flat_np(rstate)
    names, leaves, _ = _tree_flatten_with_names(got)
    assert sorted(names) == sorted(want)
    for n, x in zip(names, leaves):
        assert x.numpy().dtype == want[n].dtype, n
        np.testing.assert_array_equal(x.numpy(), want[n], err_msg=n)
    model, conv = train_state_from_reference(dataclasses.asdict(pm.cfg),
                                             want, device="cpu", **CHUNKS)
    assert all(torch.equal(a, b) for a, b in zip(
        _tree_flatten_with_names(conv)[1], leaves))
    conv, _ = make_train_step(model, AdamWConfig(**okw), loss_chunk=16)(
        conv, batch_fn(pm.cfg.vocab, seed=21))
    Checkpointer(str(tmp_path / "port")).save(2, conv, blocking=True)
    back = flat_np(RefCheckpointer(str(tmp_path / "port")).restore(rstate))
    mine = {n: x.numpy() for n, x in zip(
        *_tree_flatten_with_names(conv)[:2])}
    assert sorted(back) == sorted(mine)
    for n in back:
        assert back[n].dtype == mine[n].dtype, n
        np.testing.assert_array_equal(back[n], mine[n], err_msg=n)
    return sorted(mine)


def layer(rp, pos: str, name: str):
    """(the reference's period-0 block ``pos``'s ``name`` params, the
    port's float32 copy of them)."""
    p = jax.tree.map(lambda t: t[0], rp["layers"][pos][name])
    port: dict = {}
    for n, v in flat_np(p).items():
        *parents, leaf = n.split("/")
        node = port
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = torch.from_numpy(np.array(v))
    return p, port


def check_float32_leaves(arch, want: set):
    """The serving copy of a bfloat16 model keeps float32 exactly the
    leaves the reference reads in float32 (``want``, by leaf name) and
    the norm scales; every other leaf is bfloat16."""
    m = build_model(configs.ModelConfig(
        **dataclasses.asdict(cfg_of(arch, "bfloat16"))), "cpu", **CHUNKS)
    m.init(0)
    kept = set()
    for name, leaf in _flat(m.compute_params).items():
        last = name.split("/")[-1]
        if leaf.dtype == torch.float32:
            kept.add(last)
        else:
            assert leaf.dtype == torch.bfloat16, name
    assert kept == want | {n for n in kept if "norm" in n}
    assert all(n in kept for n in want)
