"""AdamW with gradient clipping and a warmup-cosine schedule
(``repro/training/optimizer.py`` in PyTorch).

This is not ``torch.optim.AdamW``: that one decays every leaf and rounds
in another order. Here each leaf is updated as the reference writes it,
in float32: the gradient scaled by the clip factor, m and v, their bias
corrections, ``delta = mhat / (sqrt(vhat) + eps)``, decoupled decay
``+ wd * p`` on leaves with ``ndim >= 2`` only, then ``p - lr * delta``.
The schedule is computed in float32 tensors, as the reference computes it
in float32 arrays. The state is ``{"m", "v", "step"}`` with the
parameters' tree and an int32 step, so a snapshot carries across
packages leaf for leaf. Trees are nested dicts of tensors; leaves are
visited in the reference's order (sorted keys).

On a mesh the trees are this rank's blocks, so m and v shard as the
parameters do (ZeRO); the update is elementwise and needs no collective
but the clip's global norm, which ``apply_updates`` takes as ``sumsq``
(``sharding.layout.Layout.global_sumsq``: each element counted once over
the mesh).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.checkpoint.checkpointer import (_tree_flatten_with_names,
                                                 _tree_unflatten)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_ratio * lr. ``step``:
    an int or an int tensor; the result is a float32 tensor."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params) -> dict:
    """m and v zeros in float32 with the parameters' tree, step 0."""
    names, leaves, treedef = _tree_flatten_with_names(params)

    def zeros():
        return _tree_unflatten(treedef, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves])
    dev = leaves[0].device if leaves else None
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf sums added in the reference's leaf
    order."""
    _, leaves, _ = _tree_flatten_with_names(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def apply_updates(cfg: AdamWConfig, params, grads, state, *, sumsq=None):
    """Returns (new_params, new_state, metrics); the inputs are left as
    they are. ``sumsq``: the gradients' sum of squares as a function of
    their tree, for trees sharded over a mesh (the local sum by
    default)."""
    step = state["step"]
    gnorm = global_norm(grads) if sumsq is None else torch.sqrt(sumsq(grads))
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    lr = schedule(cfg, step).to(gnorm.device)
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    _, flat_p, treedef = _tree_flatten_with_names(params)
    flat_g = _tree_flatten_with_names(grads)[1]
    flat_m = _tree_flatten_with_names(state["m"])[1]
    flat_v = _tree_flatten_with_names(state["v"])[1]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and the AdamW state differ in "
                         "structure")
    out = [upd(p.detach(), g, m, v)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_params = _tree_unflatten(treedef, [o[0] for o in out])
    new_state = {"m": _tree_unflatten(treedef, [o[1] for o in out]),
                 "v": _tree_unflatten(treedef, [o[2] for o in out]),
                 "step": step + 1}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
