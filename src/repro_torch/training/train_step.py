"""The train step: chunked cross-entropy, AdamW, remat, micro-batching
(``repro/training/train_step.py`` in PyTorch).

Chunked loss: the final hidden states go through the unembedding a
sequence chunk at a time; each chunk's (B, C, V) logits are float32, give
their loss contribution and are dropped, and the backward pass recomputes
them (``torch.utils.checkpoint``, non-reentrant), so the full (B, S, V)
logits never exist.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)`` over ``state = {"params", "opt"}``, the reference's tree. The
gradients are taken with respect to the float32 masters (the forward
casts them inside the graph, ``Model.hidden_seq(params=...)``); the
update is ``optimizer.apply_updates``, and the new parameters are
installed in the model (``Model.use_params``), so its serving methods see
them. The step is repeatable bit for bit on the card: no sum in its
backward depends on the order of atomic adds (the embedding's gradient
sorts the token ids and sums each row in a fixed order; the MoE's adds
each assignment's gradient to a row of its own, and only exact zeros
collide; see ``models/transformer.py`` and ``models/mlp.py``).

On a mesh (a model built with a ``ShardingCtx``) the state is this
rank's blocks (parameters, m, v) and the batch this rank's data-parallel
rows, as ``data.ShardedBatcher(mesh=)`` places them (``Model.place``
cuts them from a global batch). Each rank's loss is the sum over its own
rows divided by the global token count (and by the number of ranks that
hold the same rows, where a dim does not divide), so the losses add up
over the mesh to the mean; the backward pass of each gather at use sums
the gradients over the mesh, so each rank ends with the whole gradient
of its blocks. The clip uses the global norm, each element counted once
(``Layout.global_sumsq``). Micro-batches cut this rank's rows.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.checkpointer import (_tree_flatten_with_names,
                                                 _tree_unflatten)

from repro_torch.sharding import layout as lo

from . import optimizer as opt


def _chunk_loss(h, w, lab, z_loss: float):
    logits = (h @ w.T).float()                           # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    loss = torch.sum(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.sum(torch.square(lse))
    return loss


def chunked_softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token cross-entropy. hidden: (B, S, D); unembed: (V, D);
    labels: (B, S) ints. Chunks add up in order, in float32."""
    B, S, _ = hidden.shape
    return chunked_xent_sum(hidden, unembed, labels, chunk=chunk,
                            z_loss=z_loss) / (B * S)


def chunked_xent_sum(hidden: torch.Tensor, unembed: torch.Tensor,
                     labels: torch.Tensor, *, chunk: int = 512,
                     z_loss: float = 0.0) -> torch.Tensor:
    """The cross-entropy summed over the tokens (``chunked_softmax_xent``
    before its mean)."""
    B, S, D = hidden.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of the loss "
                         f"chunk {c}")
    w = unembed.to(hidden.dtype)
    labels = labels.to(hidden.device, torch.long)
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or w.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // c):
        args = (hidden[:, i * c:(i + 1) * c], w, labels[:, i * c:(i + 1) * c],
                z_loss)
        total = total + (checkpoint(_chunk_loss, *args, use_reentrant=False)
                         if remat else _chunk_loss(*args))
    return total


def make_loss_fn(model, *, remat: bool = True, loss_chunk: int = 512,
                 z_loss: float = 0.0) -> Callable:
    """(params, batch) -> loss. On a mesh: this rank's share of the mean
    (the shares add up over the mesh to it); the batch is this rank's
    data-parallel rows."""
    def loss_fn(params, batch):
        if model.layout is None:
            hidden = model.hidden_seq(batch, params=params, remat=remat)
            return chunked_softmax_xent(hidden, model.unembed(params),
                                        torch.as_tensor(batch["labels"]),
                                        chunk=loss_chunk, z_loss=z_loss)
        hidden, rows = model.hidden_rows(batch, params=params, remat=remat,
                                         placed=True)
        labels = model._own(batch["labels"], rows, True)
        total = chunked_xent_sum(hidden, model.unembed(params, hidden.dtype),
                                 labels, chunk=loss_chunk, z_loss=z_loss)
        return total / (rows.B * rows.S * rows.replicas)
    return loss_fn


def init_train_state(model, key) -> dict:
    """Draws the model's parameters (``Model.init``) and zero AdamW
    state."""
    params = model.init(key)
    return {"params": params, "opt": opt.init_state(params)}


# batch entries whose batch axis is not the first: M-RoPE's (3, B, S)
# position streams. Keyed by name: the reference's shape test
# (``x.shape[0] == 3``) would also take a batch of three rows for them.
_BATCH_AXIS = {"positions": 1}


def _split(name: str, x, microbatches: int) -> list:
    """The batch entry ``name`` cut into ``microbatches`` equal parts
    along its batch axis."""
    x = torch.as_tensor(x)
    axis = _BATCH_AXIS.get(name, 0)
    B = x.shape[axis]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         "microbatches")
    return list(torch.split(x, B // microbatches, dim=axis))


def make_train_step(model, opt_cfg: opt.AdamWConfig, *, remat: bool = True,
                    loss_chunk: int = 512, z_loss: float = 0.0,
                    microbatches: int = 1) -> Callable:
    """(state, batch) -> (state, metrics); ``batch`` holds the model's
    inputs ("tokens"; the VLM's "embeds" and "positions"; the
    encoder-decoder's "frames" and "tokens") and "labels", (B, S) ints.
    ``microbatches > 1`` accumulates gradients: the batch splits on its
    batch axis (axis 1 of "positions", axis 0 of the rest), each part's
    float32 gradients are summed and the sums scaled by 1 /
    microbatches, as the loss."""
    loss_fn = make_loss_fn(model, remat=remat, loss_chunk=loss_chunk,
                           z_loss=z_loss)

    lay = model.layout

    def value_and_grad(leaves, treedef, batch):
        xs = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(_tree_unflatten(treedef, xs), batch)
            gs = torch.autograd.grad(loss, xs, allow_unused=True)
        loss = loss.detach()
        if lay is not None:       # the shares summed: the mean everywhere
            loss = lo.psum(loss, lay.axes(lay.all))
        return loss, [torch.zeros_like(x) if g is None else g
                      for x, g in zip(xs, gs)]

    def grads_of(params, batch):
        _, leaves, treedef = _tree_flatten_with_names(params)
        if microbatches == 1:
            loss, gs = value_and_grad(leaves, treedef, batch)
            return loss, _tree_unflatten(treedef, gs)
        parts = {k: _split(k, v, microbatches) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(microbatches):
            loss, gs = value_and_grad(leaves, treedef,
                                      {k: v[i] for k, v in parts.items()})
            loss_sum = loss_sum + loss
            g_sum = [a + b.float() for a, b in zip(g_sum, gs)]
        inv = 1.0 / microbatches
        return loss_sum * inv, _tree_unflatten(treedef,
                                               [g * inv for g in g_sum])

    def train_step(state, batch):
        loss, grads = grads_of(state["params"], batch)
        params, opt_state, metrics = opt.apply_updates(
            opt_cfg, state["params"], grads, state["opt"],
            sumsq=None if lay is None else lay.global_sumsq)
        model.use_params(params)
        return ({"params": model.params, "opt": opt_state},
                dict(metrics, loss=loss))

    return train_step
