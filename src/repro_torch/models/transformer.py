"""The decoder stack of the dense and MoE families
(``repro/models/transformer.py`` in PyTorch).

Parameters are stacked over periods as in the reference: every leaf under
``params["layers"]["pos{j}"]`` has a leading (n_layers / period) axis, so
the reference's tree carries across leaf by leaf. The stack runs as a
Python loop over periods, each taking its slice of every stacked leaf
(``torch.unbind``, whose backward stacks the slices' gradients). Caches
are stacked the same way and decode writes each layer's new row in place.

The apply functions take the parameter tree in the compute dtype, norm
scales and the MoE router in float32. Serving hands them the model's cast
copy (``Model.compute_params``); training hands ``forward_seq`` the
float32 masters with ``cast=dtype``, and each period casts its slice
inside the autograd graph, as the reference casts with ``.astype`` at each
use, so the gradients land on the float32 leaves. ``remat=True``
recomputes each period in the backward pass (``torch.utils.checkpoint``,
non-reentrant); ``remat_policy="dots"`` keeps the outputs of the matrix
products (selective activation checkpointing), as the reference's
``checkpoint_dots``. The other block kinds (MLA, Mamba, xLSTM) are ROADMAP
item 13c.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import mlp
from .common import embed_init, rms_norm, split_keys

_PORTED = (("gqa", "swiglu"), ("gqa", "moe"))


# --------------------------------------------------------------- structure
def block_kind(cfg, j: int) -> tuple[str, str | None]:
    """(mixer, ffn) type names for period position j."""
    if cfg.family == "ssm":
        mixer = "slstm" if cfg.is_slstm_layer(j) else "mlstm"
        return mixer, None
    mixer = ("mla" if cfg.mla else "gqa") if cfg.is_attn_layer(j) else "mamba"
    ffn = "moe" if cfg.is_moe_layer(j) else "swiglu"
    return mixer, ffn


def block_ffn(cfg, j: int) -> str:
    """The block's FFN kind; raises for the block kinds not ported."""
    kind = block_kind(cfg, j)
    if kind not in _PORTED:
        raise NotImplementedError(
            f"block {kind} of {cfg.name!r} is not ported; the port has the "
            "GQA decoder with a SwiGLU or MoE FFN (ROADMAP item 13c)")
    return kind[1]


def init_block(key, cfg, j: int) -> dict:
    ffn = block_ffn(cfg, j)
    ks = split_keys(key, 2)
    dev = key.device
    p = {"norm1": torch.ones(cfg.d_model, device=dev),
         "attn": attn.init_gqa(ks[0], cfg),
         "norm2": torch.ones(cfg.d_model, device=dev)}
    if ffn == "moe":
        p["moe"] = mlp.init_moe(ks[1], cfg)
    else:
        p["ffn"] = mlp.init_swiglu(ks[1], cfg.d_model, cfg.d_ff,
                                   cfg.n_layers)
    return p


def _keeps_float32(name: str) -> bool:
    """Leaves the apply functions read in float32: norm scales and the
    MoE router (the reference routes in float32)."""
    return "norm" in name or name == "router"


def cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """The tree in the compute dtype, norm scales and the router left
    float32; differentiable (the model's serving copy detaches first)."""
    return {k: (cast_tree(v, dtype) if isinstance(v, dict)
                else v if _keeps_float32(k) else v.to(dtype))
            for k, v in tree.items()}


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unstack(tree, n: int) -> list:
    """The n slices of a tree stacked on its leading axis."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def init_decoder(key, cfg, *, with_embed: bool = True) -> dict:
    period = cfg.layer_period
    n_periods = cfg.n_layers // period
    if cfg.n_layers % period:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the "
                         f"period {period}")
    keys = split_keys(key, 3 + cfg.n_layers)
    params: dict[str, Any] = {}
    if with_embed:
        params["embed"] = {"table": embed_init(keys[0], cfg.vocab,
                                               cfg.d_model)}
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(keys[1], cfg.vocab, cfg.d_model)
    layers: dict[str, Any] = {}
    for j in range(period):
        layers[f"pos{j}"] = _stack([init_block(keys[3 + i * period + j],
                                               cfg, j)
                                    for i in range(n_periods)])
    params["layers"] = layers
    params["final_norm"] = torch.ones(cfg.d_model, device=key.device)
    return params


# ------------------------------------------------------------------ caches
def init_block_cache(cfg, j: int, batch: int, cache_len: int, dtype,
                     device=None):
    block_ffn(cfg, j)
    kv = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(kv, dtype=dtype, device=device),
            torch.zeros(kv, dtype=dtype, device=device))


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """{"pos{j}": (k, v)}, each (n_periods, B, cache_len, KVH, dh): real
    zeros, not a broadcast view, since decode writes rows in place."""
    period = cfg.layer_period
    n_periods = cfg.n_layers // period
    caches = {}
    for j in range(period):
        one = init_block_cache(cfg, j, batch, cache_len, dtype, device)
        caches[f"pos{j}"] = tuple(
            x[None].repeat((n_periods,) + (1,) * x.dim()) for x in one)
    return caches


# ------------------------------------------------------------- block apply
def _ffn(cfg, p, hn):
    """The block's FFN: the MoE where the block has one, else SwiGLU."""
    if "moe" in p:
        return mlp.moe_apply(cfg, p["moe"], hn)
    return mlp.swiglu(p["ffn"], hn)


def apply_block_seq(cfg, p, j: int, h, positions, *, q_chunk, kv_chunk,
                    skip_masked_blocks=False):
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + attn.gqa_train(cfg, p["attn"], hn, positions, q_chunk=q_chunk,
                           kv_chunk=kv_chunk,
                           skip_masked_blocks=skip_masked_blocks)
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + _ffn(cfg, p, hn)


def apply_block_prefill(cfg, p, j, h, positions, cache_len, *, q_chunk,
                        kv_chunk, skip_masked_blocks=False):
    """Like seq but also returns the cache for serving."""
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    mix, cache = attn.gqa_prefill(cfg, p["attn"], hn, positions, cache_len,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk,
                                  skip_masked_blocks=skip_masked_blocks)
    h = h + mix
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + _ffn(cfg, p, hn), cache


def apply_block_decode(cfg, p, j, h, pos: int, cache):
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    mix, cache = attn.gqa_decode(cfg, p["attn"], hn, pos, cache)
    h = h + mix
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + _ffn(cfg, p, hn), cache


# ----------------------------------------------------------------- forward
def embed_tokens(cfg, params, tokens, dtype):
    # gather first, cast after: avoids materializing a casted copy of the
    # full (V, D) table per step. ``F.embedding``'s backward on the card
    # sorts the ids and sums each row's gradients in a fixed order (no
    # atomics), so a train step's table gradient is repeatable bit for bit.
    return F.embedding(tokens, params["embed"]["table"]).to(dtype)


def unembed_matrix(cfg, params):
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"])


def _periods(cfg, params):
    """Each period's parameters: layer i's slice of every stacked leaf."""
    return _unstack(params["layers"], cfg.n_layers // cfg.layer_period)


# aten ops whose outputs the 'dots' policy keeps: the matrix products
# (``@`` and ``einsum`` reach these).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = ("nothing", "dots")


def forward_seq(cfg, params, h, positions, *, q_chunk: int = 1024,
                kv_chunk: int = 1024, skip_masked_blocks: bool = False,
                remat: bool = False, remat_policy: str = "nothing",
                cast: torch.dtype | None = None):
    """Body of full-sequence passes: h (B, S, D) -> final hidden.

    ``cast``: the layers' parameters are float32 masters, cast to this
    dtype inside each period. ``remat``: checkpoint each period (when
    autograd records), keeping what ``remat_policy`` names: 'nothing'
    (the period's input only) or 'dots' (also the products' outputs)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                         f"{REMAT_POLICIES}")

    def period(h, pp):
        if cast is not None:
            pp = cast_tree(pp, cast)
        for j in range(cfg.layer_period):
            h = apply_block_seq(cfg, pp[f"pos{j}"], j, h, positions,
                                q_chunk=q_chunk, kv_chunk=kv_chunk,
                                skip_masked_blocks=skip_masked_blocks)
        return h

    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    remat = remat and torch.is_grad_enabled()
    for pp in _periods(cfg, params):
        h = (checkpoint(period, h, pp, use_reentrant=False, **kw) if remat
             else period(h, pp))
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def forward_prefill(cfg, params, h, positions, cache_len, *, q_chunk=1024,
                    kv_chunk=1024, skip_masked_blocks=False):
    per: dict = {f"pos{j}": [] for j in range(cfg.layer_period)}
    for period_params in _periods(cfg, params):
        for j in range(cfg.layer_period):
            h, cache = apply_block_prefill(
                cfg, period_params[f"pos{j}"], j, h, positions, cache_len,
                q_chunk=q_chunk, kv_chunk=kv_chunk,
                skip_masked_blocks=skip_masked_blocks)
            per[f"pos{j}"].append(cache)
    caches = {name: (torch.stack([c[0] for c in cs]),
                     torch.stack([c[1] for c in cs]))
              for name, cs in per.items()}
    return rms_norm(h, params["final_norm"], cfg.norm_eps), caches


def forward_decode(cfg, params, h, pos: int, caches):
    """One token through the stack; each layer's cache row ``pos`` is
    written in place, and ``caches`` is returned."""
    for i, period_params in enumerate(_periods(cfg, params)):
        for j in range(cfg.layer_period):
            k, v = caches[f"pos{j}"]
            h, _ = apply_block_decode(cfg, period_params[f"pos{j}"], j, h,
                                      pos, (k[i], v[i]))
    return rms_norm(h, params["final_norm"], cfg.norm_eps), caches
