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

Runs on ``cuda:0`` unless ``--device cpu``. ``--mesh`` other than
``none`` and ``--multi-pod`` are the LM on a mesh (ROADMAP item 13d);
``--host-devices`` forces JAX host devices and has no counterpart here.
The VLM is refused: the reference's trainer feeds only tokens, and its
model then raises ``KeyError: 'embeds'`` (train it through
``training.make_train_step`` with an ``embeds`` / ``positions`` batch).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

_MESH = "ROADMAP item 13d (the LM on a mesh)"


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


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 1e-3,
          microbatches: int = 1, ckpt_dir: str = "", ckpt_every: int = 50,
          log_every: int = 10, seed: int = 0, device=None,
          stop_at: int | None = None, log=print) -> dict:
    """The trainer's loop for a config: weights from ``seed``, AdamW with
    the CLI's schedule (warmup max(10, steps // 20), cosine to ``steps``),
    restore on start from ``ckpt_dir``'s latest snapshot, a snapshot every
    ``ckpt_every`` steps and a blocking one at the end. ``stop_at`` ends
    the run before that step without the final snapshot (a kill). Returns
    {"losses", "step_s", "monitor", "state", "model", "start_step"}."""
    import torch

    refuse_vlm(cfg, "trainer")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import ShardedBatcher, make_lm_tokens
    from repro_torch.models import build_model
    from repro_torch.runtime import StepTimeMonitor
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    model = build_model(cfg, device, q_chunk=min(1024, seq),
                        kv_chunk=min(1024, seq))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(10, steps // 20),
                          total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, loss_chunk=min(512, seq),
                              microbatches=microbatches)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        # the snapshot replaces every leaf, so the weights are not drawn
        state = ckpt.restore(_state_like(cfg), device=model.device)
        model.use_params(state["params"])
        state["params"] = model.params
        start_step = ckpt.latest_step()
        log(f"restored checkpoint at step {start_step}")
    else:
        state = init_train_state(model, seed)
    log(f"arch={cfg.name} params={model.num_params():,} "
        f"device={model.device}")

    stream = make_lm_tokens(max(steps, 200) * batch * seq + seq + 1,
                            cfg.vocab, seed=seed)
    batcher = ShardedBatcher(stream, batch, seq, device=model.device)
    batcher.seek(start_step)
    monitor = StepTimeMonitor()
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else lambda: None)

    it = iter(batcher)
    extra = {}
    if cfg.enc_dec:         # the reference's trainer: zero frames a step
        extra["frames"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
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
            ckpt.save(step + 1, state)
    if ckpt is not None:
        if stop_at is None:
            ckpt.save(steps, state, blocking=True)
        else:
            ckpt.wait()
    return {"losses": losses, "step_s": step_s,
            "monitor": monitor.summary(), "state": state, "model": model,
            "start_step": start_step}


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
                    help="'none' (a mesh is " + _MESH + ")")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="no counterpart in the port (refused)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)

    if args.mesh != "none" or args.multi_pod:
        raise NotImplementedError(f"--mesh {args.mesh!r} / --multi-pod: "
                                  f"training on a mesh is {_MESH}")
    if args.host_devices:
        raise NotImplementedError(
            "--host-devices forces N emulated JAX host devices through "
            "XLA_FLAGS; the port has no counterpart (a mesh is "
            f"{_MESH})")

    from repro_torch.configs import get_config

    print(f"arch={args.arch} preset={args.preset}")
    out = train(preset(get_config(args.arch), args.preset),
                steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, microbatches=args.microbatches,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                log_every=args.log_every, seed=args.seed,
                device=args.device)
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
