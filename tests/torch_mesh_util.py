"""Harness of the LM-on-a-mesh tests (tests/test_torch_mesh_*.py): the
port's gloo ranks and the reference's emulated JAX devices, each in
processes of their own, fed the same numpy inputs through files.

``run_ranks(code, outdir)`` starts ``world`` ranks of ``code`` (argv:
rank, world, the file store, ``outdir``; ``RANK_HEADER`` makes the
process group and a 2 x 2 ('data', 'model') CPU mesh) and returns each
rank's ``rank{r}.npz``; ``start_reference(code, args)`` starts the
reference in a subprocess with four forced host devices (start it first:
both then run side by side) and ``finish`` waits for it.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TESTS = os.path.abspath(os.path.dirname(__file__))

RANK_HEADER = """
import sys, numpy as np, torch, torch.distributed as dist
sys.path.insert(0, {tests!r})
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                           sys.argv[3], sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{{store}}", rank=rank,
                        world_size=world)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.specs import make_ctx
mesh = make_host_mesh((2, 2), device="cpu")
ctx = make_ctx(mesh)
res = {{}}
""".format(tests=TESTS)

RANK_FOOTER = """
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""

REF_HEADER = """
import sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
from repro.launch.mesh import make_host_mesh
from repro.launch import specs as rsp
mesh = make_host_mesh((2, 2))
ctx = rsp.make_ctx(mesh)
out = {{}}
""".format(tests=TESTS)


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""), **extra)


def run_ranks(code: str, outdir: Path, world: int = 4,
              timeout: float = 300.0) -> list:
    """Run ``code`` (after ``RANK_HEADER``, before ``RANK_FOOTER``) as
    ``world`` gloo ranks; if one fails, stop the others. Returns each
    rank's results."""
    src = RANK_HEADER + textwrap.dedent(code) + RANK_FOOTER
    init = Path(outdir) / "store"
    init.unlink(missing_ok=True)        # a file store serves one group
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(world), str(init),
         str(outdir)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    failed: list = []
    while any(p.poll() is None for p in procs):
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    logs = [p.communicate()[0] for p in procs]
    for r in failed + [r for r in range(world) if r not in failed]:
        assert procs[r].returncode == 0, \
            f"rank {r} (rc {procs[r].returncode}):\n{logs[r]}"
    return [dict(np.load(Path(outdir) / f"rank{r}.npz"))
            for r in range(world)]


def start_reference(code: str, args: list, n_devices: int = 4):
    """The reference's side (after ``REF_HEADER``) in a JAX subprocess
    with ``n_devices`` emulated host devices; returns the Popen."""
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    return subprocess.Popen(
        [sys.executable, "-c", REF_HEADER + textwrap.dedent(code),
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish(proc, timeout: float = 300.0) -> None:
    log = proc.communicate(timeout=timeout)[0]
    assert proc.returncode == 0, log


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------ whole models on 2 x 2
B, S, CACHE, STEPS, LR = 4, 32, 48, 4, 1e-3
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=8)


def model_inputs(arch: str, vocab: int, d_model: int, enc_seq: int,
                 family: str, seed: int = 0) -> dict:
    """A family's batch (with labels) and the decode tokens, from
    ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "dec": rng.integers(0, vocab, (B, STEPS)).astype(np.int32)}
    if family == "vlm":
        out["embeds"] = rng.normal(size=(B, S, d_model)).astype(np.float32)
        t = np.arange(S)
        out["positions"] = np.broadcast_to(
            np.stack([t, t // 4, t % 4]), (B, 3, S)).transpose(
            1, 0, 2).astype(np.int32).copy()
    else:
        out["tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    if enc_seq:
        out["frames"] = rng.normal(size=(B, enc_seq, d_model)).astype(
            np.float32)
    return out


MODEL_REF = """
import dataclasses, functools
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.models import build_model
from repro.sharding import param_specs
from repro.training import AdamWConfig, apply_updates, init_state
from repro.training.train_step import make_loss_fn
from conftest import reduce_cfg
from torch_mesh_util import B, S, CACHE, STEPS, LR, CHUNKS, model_inputs
archs = sys.argv[2].split(",")

def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

for a in archs:
    cfg = reduce_cfg(get_config(a.split("+")[0]), dtype="float32")
    model = build_model(cfg, ctx, seq_parallel_attn=a.endswith("+sp"),
                        **CHUNKS)
    params = model.init(jax.random.PRNGKey(4))
    specs = param_specs(ctx, params)
    params = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs))
    inp = model_inputs(a, cfg.vocab, cfg.d_model,
                       cfg.enc_seq if cfg.enc_dec else 0, cfg.family)
    batch = {k: jnp.asarray(v) for k, v in inp.items()
             if k not in ("labels", "dec")}
    for k, v in flat(params).items():
        out[f"{a}|p|{k}"] = v
    out[f"{a}|hidden"] = np.asarray(jax.jit(
        functools.partial(model.hidden_seq, remat=False))(params, batch))
    lg, caches = jax.jit(model.prefill, static_argnums=2)(params, batch,
                                                         CACHE)
    out[f"{a}|prefill"] = np.asarray(lg)
    for i, c in enumerate(jax.tree.leaves(caches)):
        out[f"{a}|cache|{i}"] = np.asarray(c)
    dec = jax.jit(model.decode)
    for i in range(STEPS):
        lg, caches = dec(params, jnp.asarray(inp["dec"][:, i:i + 1]),
                         jnp.int32(S + i), caches)
        out[f"{a}|decode|{i}"] = np.asarray(lg)
    batch["labels"] = jnp.asarray(inp["labels"])
    loss, g = jax.jit(jax.value_and_grad(make_loss_fn(model, loss_chunk=16)))(
        params, batch)
    out[f"{a}|loss"] = np.asarray(loss)
    for k, v in flat(g).items():
        out[f"{a}|g|{k}"] = v
    # the train step's update of these gradients (the step itself would
    # compile the backward pass a second time)
    new, _, met = jax.jit(functools.partial(apply_updates, AdamWConfig(
        lr=LR, warmup_steps=1, total_steps=10)))(params, g,
                                                 init_state(params))
    out[f"{a}|grad_norm"] = np.asarray(met["grad_norm"])
    for k, v in flat(new).items():
        out[f"{a}|new|{k}"] = v
np.savez(sys.argv[1], **out)
"""

MODEL_PORT = """
import torch
from repro_torch.checkpoint.checkpointer import (_tree_flatten_with_names,
                                                 _tree_unflatten)
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, init_state, make_loss_fn,
                                  make_train_step)
from repro_torch.training.optimizer import global_norm
from conftest import reduce_cfg
from torch_mesh_util import B, S, CACHE, STEPS, LR, CHUNKS, model_inputs
ref = np.load(f"{out}/ref.npz")
archs = ARCHS

def nest(flat):
    tree = {}
    for path, v in flat.items():
        *ps, name = path.split("/")
        node = tree
        for p in ps:
            node = node.setdefault(p, {})
        node[name] = v
    return tree

for a in archs:
    cfg = reduce_cfg(get_config(a.split("+")[0]), dtype="float32")
    model = build_model(cfg, ctx, device="cpu",
                        seq_parallel_attn=a.endswith("+sp"), **CHUNKS)
    pre = f"{a}|p|"
    model.load_params(nest({k[len(pre):]: ref[k] for k in ref.files
                            if k.startswith(pre)}))
    inp = model_inputs(a, cfg.vocab, cfg.d_model,
                       cfg.enc_seq if cfg.enc_dec else 0, cfg.family)
    batch = {k: v for k, v in inp.items() if k not in ("labels", "dec")}
    res[f"{a}|hidden"] = model.hidden_seq(batch).numpy()
    held = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
            for t in (model.params, model.compute_params)
            for x in _tree_flatten_with_names(t)[1]}
    res[f"{a}|serve_bytes"] = np.array([sum(held.values())])
    lg, caches = model.prefill(batch, CACHE)
    res[f"{a}|prefill"] = lg.numpy()
    for i, c in enumerate(_tree_flatten_with_names(
            model.full_cache(caches))[1]):
        res[f"{a}|cache|{i}"] = c.numpy()
    for i in range(STEPS):
        lg, caches = model.decode(inp["dec"][:, i:i + 1], S + i, caches)
        res[f"{a}|decode|{i}"] = lg.numpy()
    batch["labels"] = inp["labels"]
    placed = model.place(batch)
    names, leaves, td = _tree_flatten_with_names(model.params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    share = make_loss_fn(model, loss_chunk=16)(_tree_unflatten(td, xs),
                                               placed)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(
        xs, torch.autograd.grad(share, xs, allow_unused=True))]
    res[f"{a}|share"] = share.detach().numpy()
    full_g = model.full(_tree_unflatten(td, list(gs)))
    for n, g in zip(*_tree_flatten_with_names(full_g)[:2]):
        res[f"{a}|g|{n}"] = g.numpy()
    step = make_train_step(model, AdamWConfig(lr=LR, warmup_steps=1,
                                              total_steps=10), loss_chunk=16)
    p_bytes = sum(x.numel() * 4 for x in leaves)
    st, met = step({"params": model.params,
                    "opt": init_state(model.params)}, placed)
    res[f"{a}|grad_norm"] = met["grad_norm"].numpy()
    res[f"{a}|loss"] = met["loss"].numpy()
    _, ol, _ = _tree_flatten_with_names(st["opt"])
    res[f"{a}|bytes"] = np.array([p_bytes + sum(x.numel() * x.element_size()
                                                for x in ol)])
    for n, v in zip(*_tree_flatten_with_names(model.full(st["params"]))[:2]):
        res[f"{a}|new|{n}"] = v.numpy()
"""


def model_runs(archs, outdir: Path):
    """The reference's whole-model runs on its 2 x 2 host mesh under
    ``jit``, then the port's on four gloo ranks holding the same
    parameters: {arch|what: array} and each rank's {arch|what: array}.
    An arch named with "+sp" is built with ``seq_parallel_attn=True`` in
    both packages."""
    finish(start_reference(MODEL_REF, [Path(outdir) / "ref.npz",
                                       ",".join(archs)]), timeout=600)
    ranks = run_ranks(f"ARCHS = {list(archs)!r}\n" + MODEL_PORT, outdir,
                      timeout=600)
    return dict(np.load(Path(outdir) / "ref.npz")), ranks


def check_model(ref, ranks, arch, band=1e-4):
    """Forward, prefill (logits and gathered caches), decode, loss,
    every gradient leaf, the update and ``grad_norm`` of one family."""
    a = arch
    for r in ranks:
        for what in ("hidden", "prefill") + tuple(
                f"decode|{i}" for i in range(STEPS)):
            if f"{a}|{what}" in ref:
                assert rel(r[f"{a}|{what}"], ref[f"{a}|{what}"]) < band, what
        caches = sorted((k for k in ref if k.startswith(f"{a}|cache|")),
                        key=lambda k: int(k.split("|")[-1]))
        assert len(caches) == len([k for k in r
                                   if k.startswith(f"{a}|cache|")])
        for k in caches:
            if np.abs(ref[k]).max() > 0:
                assert rel(r[k], ref[k]) < band, k
            else:
                np.testing.assert_array_equal(r[k], ref[k])
        assert abs(float(r[f"{a}|loss"]) - float(ref[f"{a}|loss"])) <= \
            band * abs(float(ref[f"{a}|loss"]))
        grads = [k for k in ref if k.startswith(f"{a}|g|")]
        assert sorted(grads) == sorted(k for k in r
                                       if k.startswith(f"{a}|g|"))
        top = max(float(np.abs(ref[k]).max()) for k in grads)
        for k in grads:
            w = float(np.abs(ref[k]).max())
            if w <= band * top:     # an exactly zero gradient (whisper's bk)
                assert float(np.abs(r[k]).max()) <= band * top, k
            else:
                assert rel(r[k], ref[k]) < band, k
        assert abs(float(r[f"{a}|grad_norm"]) - float(
            ref[f"{a}|grad_norm"])) <= 1e-5 * float(ref[f"{a}|grad_norm"])
        for k in (k for k in ref if k.startswith(f"{a}|new|")):
            np.testing.assert_allclose(r[k], ref[k], rtol=1e-3,
                                       atol=1.5 * 2 * LR, err_msg=k)
    # every rank's share of the loss adds up to the mean
    total = sum(float(r[f"{a}|share"]) for r in ranks)
    assert abs(total - float(ref[f"{a}|loss"])) <= \
        band * abs(float(ref[f"{a}|loss"]))
