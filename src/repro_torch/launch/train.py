"""End-to-end LM training driver (``repro/launch/train.py`` in
PyTorch).

Trains a registered architecture (``--arch``: the decoder-only families
and the encoder-decoder, fed zero frames as the reference's trainer feeds
them) at a scale preset (``--preset tiny|small|full``) on a synthetic token
stream (``make_lm_tokens``), through the port's substrate: the token
batcher (``data.ShardedBatcher``), AdamW with chunked cross-entropy,
remat and optional micro-batching (``training/``), checkpointing with
restore on start (``checkpoint.Checkpointer``, snapshots the reference's
trainer can read) and the straggler monitor (``runtime.StepTimeMonitor``).
The last line printed is a JSON object with ``first_loss``,
``last_loss`` and the monitor's summary.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-135m --preset tiny --steps 200

Runs on ``cuda:0`` unless ``--device cpu``. ``--host-devices`` forces
JAX host devices and has no counterpart here.

On a mesh (``--mesh RxC``, ('data', 'model'); ``--mesh production``, 16 x
16, or 2 x 16 x 16 with ``--multi-pod``, which ``RxC`` ignores as the
reference does) the trainer runs one process a rank. The caller creates
the process group; the CLI makes one from the environment that
``torchrun`` sets (``--backend``, gloo by default) when none exists.
Initialization is sharded: each rank draws the layers one at a time as
one device draws them and keeps its blocks (``models.Model``); AdamW's
state is sharded the same way; batches come from
``ShardedBatcher(mesh=)``. Snapshots hold the one-device layout, gathered
leaf by leaf into rank 0's host memory and written by rank 0 alone
(``Layout.gather_host``), so the one-device trainer and the reference's
read them; a restore reads each leaf memory-mapped and keeps this rank's
block. No rank holds the whole state on its device.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --mesh 2x2 --preset tiny --device cpu --steps 20
The VLM is refused: the reference's trainer feeds only tokens, and its
model then raises ``KeyError: 'embeds'`` (train it through
``training.make_train_step`` with an ``embeds`` / ``positions`` batch).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time


def refuse_vlm(cfg, launcher: str) -> None:
    """The launchers feed token batches; the VLM's batch is ``embeds`` and
    ``positions``, which the reference's launchers do not make either."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name!r} (the VLM) takes an 'embeds' / 'positions' batch; "
            f"the {launcher} feeds tokens only, as the reference's does, "
            f"whose model then raises KeyError: 'embeds'. Drive "
            f"Model.prefill / decode or training.make_train_step with such "
            f"a batch instead")


def preset(cfg, name: str):
    """The reference trainer's scale presets."""
    if name == "tiny":
        return dataclasses.replace(
            cfg, n_layers=cfg.layer_period * 2, d_model=128, n_heads=4,
            n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4, head_dim=32,
            d_ff=256 if cfg.d_ff else 0, vocab=2048,
            **({"n_experts": 4, "top_k": 2, "moe_d_ff": 64}
               if cfg.n_experts else {}),
            **({"n_enc_layers": 2, "enc_seq": 64} if cfg.enc_dec else {}),
            **({"mrope_sections": (4, 6, 6)} if cfg.mrope else {}),
            **({"kv_lora_rank": 64, "q_lora_rank": 96, "qk_rope_dim": 16,
                "qk_nope_dim": 32, "v_head_dim": 32} if cfg.mla else {}))
    if name == "small":
        return dataclasses.replace(cfg, n_layers=cfg.layer_period * 2)
    return cfg


def _state_like(cfg) -> dict:
    """A train state's structure and shapes, on the meta device."""
    import torch

    from repro_torch.models.model import param_shapes

    def tree():
        out: dict = {}
        for path, shape in param_shapes(cfg).items():
            *parents, leaf = path.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.empty(shape, device="meta")
        return out
    return {"params": tree(), "opt": {
        "m": tree(), "v": tree(),
        "step": torch.empty((), dtype=torch.int32, device="meta")}}


def _host_state(model, state) -> dict | None:
    """A mesh's train state in the one-device layout, on rank 0's host
    (None on the other ranks; every rank calls it)."""
    lay = model.layout
    parts = {"params": lay.gather_host(state["params"]),
             "m": lay.gather_host(state["opt"]["m"]),
             "v": lay.gather_host(state["opt"]["v"])}
    if parts["params"] is None:
        return None
    return {"params": parts["params"],
            "opt": {"m": parts["m"], "v": parts["v"],
                    "step": state["opt"]["step"].cpu()}}


def _restore_block(model, name: str, a):
    """A restored leaf (memory-mapped) as this rank's block on the
    model's device: the parameters and m / v by their parameter's spec,
    the step whole."""
    import numpy as np
    import torch
    for pre in ("params/", "opt/m/", "opt/v/"):
        if name.startswith(pre):
            return model.layout.keep(name[len(pre):], a,
                                     device=model.device)
    return torch.from_numpy(np.array(a)).to(model.device)


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 1e-3,
          microbatches: int = 1, ckpt_dir: str = "", ckpt_every: int = 50,
          log_every: int = 10, seed: int = 0, device=None,
          stop_at: int | None = None, log=print, mesh=None,
          remat: bool = True) -> dict:
    """The trainer's loop for a config: weights from ``seed``, AdamW with
    the CLI's schedule (warmup max(10, steps // 20), cosine to ``steps``),
    restore on start from ``ckpt_dir``'s latest snapshot, a snapshot every
    ``ckpt_every`` steps and a blocking one at the end. ``stop_at`` ends
    the run before that step without the final snapshot (a kill).
    ``mesh``: a ``DeviceMesh`` ('data', 'model'[, 'pod']) to train on,
    every rank calling ``train`` alike; the returned state is then this
    rank's blocks. Returns {"losses", "step_s", "monitor", "state",
    "model", "start_step"}."""
    import torch
    import torch.distributed as dist

    refuse_vlm(cfg, "trainer")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import ShardedBatcher, make_lm_tokens
    from repro_torch.models import build_model
    from repro_torch.runtime import StepTimeMonitor
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    ctx = None
    if mesh is not None:
        from repro_torch.launch.specs import make_ctx
        ctx = make_ctx(mesh)
        if device is None:
            device = mesh.device_type
    model = build_model(cfg, ctx, device, q_chunk=min(1024, seq),
                        kv_chunk=min(1024, seq))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(10, steps // 20),
                          total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, remat=remat,
                              loss_chunk=min(512, seq),
                              microbatches=microbatches)
    writer = mesh is None or dist.get_rank() == 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if mesh is not None:
        dist.barrier()   # every rank's Checkpointer is made before a write
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        # the snapshot replaces every leaf, so the weights are not drawn
        state = ckpt.restore(
            _state_like(cfg), device=model.device,
            place=None if mesh is None else functools.partial(
                _restore_block, model))
        model.use_params(state["params"])
        state["params"] = model.params
        start_step = ckpt.latest_step()
        log(f"restored checkpoint at step {start_step}")
    else:
        state = init_train_state(model, seed)
    where = "" if mesh is None else " mesh=" + "x".join(
        f"{n}{a}" for n, a in zip(mesh.mesh.shape, mesh.mesh_dim_names))
    log(f"arch={cfg.name} params={model.num_params():,} "
        f"device={model.device}{where}")

    def snapshot(step, **kw):
        full = state if mesh is None else _host_state(model, state)
        if writer:
            ckpt.save(step, full, **kw)

    stream = make_lm_tokens(max(steps, 200) * batch * seq + seq + 1,
                            cfg.vocab, seed=seed)
    batcher = ShardedBatcher(
        stream, batch, seq, device=model.device, mesh=mesh,
        batch_axes=("data",) if ctx is None else ctx.dp_axes)
    batcher.seek(start_step)
    monitor = StepTimeMonitor()
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else lambda: None)

    it = iter(batcher)
    extra = {}
    if cfg.enc_dec:         # the reference's trainer: zero frames a step
        rows = batch // (1 if mesh is None else model.layout.size(ctx.dp_axes))
        extra["frames"] = torch.zeros((rows, cfg.enc_seq, cfg.d_model),
                                      device=model.device)
    losses, step_s = [], []
    end = steps if stop_at is None else min(steps, stop_at)
    for step in range(start_step, end):
        tokens, labels = next(it)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens, "labels": labels,
                                         **extra})
        loss = float(metrics["loss"])
        sync()
        dt = time.perf_counter() - t0
        if monitor.observe(step, dt):
            log(f"  [straggler] step {step} took {dt:.2f}s "
                f"(ema {monitor.ema:.2f}s)")
        losses.append(loss)
        step_s.append(dt)
        if step % log_every == 0 or step == steps - 1:
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            snapshot(step + 1)
    if ckpt is not None:
        if stop_at is None:
            snapshot(steps, blocking=True)
        elif writer:
            ckpt.wait()
        if mesh is not None:    # no rank reads before rank 0's write ends
            dist.barrier()
    return {"losses": losses, "step_s": step_s,
            "monitor": monitor.summary(), "state": state, "model": model,
            "start_step": start_step}


def make_mesh(spec: str, multi_pod: bool = False, device=None,
              backend: str = "gloo"):
    """The CLI's mesh: None for 'none', the production mesh for
    'production', an R x C ('data', 'model') host mesh for 'RxC'. Without
    a process group one is made from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) with ``backend``."""
    if spec == "none":
        return None
    import os

    import torch.distributed as dist

    from .mesh import make_host_mesh, make_production_mesh
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--mesh {spec} runs one process a rank in a process group; "
                "start the ranks with torchrun (or set RANK, WORLD_SIZE, "
                "MASTER_ADDR and MASTER_PORT)")
        dist.init_process_group(backend)
    if spec == "production":
        return make_production_mesh(multi_pod=multi_pod, device=device)
    try:
        shape = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: 'none', 'production' or "
                         "'RxC'") from None
    return make_host_mesh(shape, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="none",
                    help="'none', 'RxC' ('data' x 'model') or 'production'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh production: 2 x 16 x 16")
    ap.add_argument("--backend", default="gloo",
                    help="the process group's backend when the CLI makes "
                         "it from torchrun's environment")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="no counterpart in the port (refused)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)

    if args.host_devices:
        raise NotImplementedError(
            "--host-devices forces N emulated JAX host devices through "
            "XLA_FLAGS; the port has no counterpart (a mesh is one process "
            "a rank: --mesh under torchrun)")

    from repro_torch.configs import get_config

    mesh = make_mesh(args.mesh, args.multi_pod, args.device, args.backend)
    print(f"arch={args.arch} preset={args.preset}")
    out = train(preset(get_config(args.arch), args.preset),
                steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, microbatches=args.microbatches,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                log_every=args.log_every, seed=args.seed,
                device=args.device, mesh=mesh)
    losses = out["losses"]
    if not losses:
        print(f"nothing to train: the checkpoint is at step "
              f"{out['start_step']} of {args.steps}")
        return 0
    print(json.dumps({"first_loss": losses[0], "last_loss": losses[-1],
                      "monitor": out["monitor"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
