"""The decoder stack of the dense family (``repro/models/transformer.py``
in PyTorch).

Parameters are stacked over periods as in the reference: every leaf under
``params["layers"]["pos{j}"]`` has a leading (n_layers / period) axis, so
the reference's tree carries across leaf by leaf. A dense model's period
is one layer; the stack runs as a Python loop in which layer i takes
``leaf[i]`` of each leaf (a view). Caches are stacked the same way and
decode writes each layer's new row in place.

The apply functions take the parameter tree in the compute dtype (the
reference casts each weight with ``.astype(x.dtype)`` at each use; the
model keeps that copy once, ``Model.compute_params``), norm scales in
float32. The other block kinds (MLA, MoE, Mamba, xLSTM) are ROADMAP item
13c.
"""
from __future__ import annotations

from typing import Any

import torch

from . import attention as attn
from . import mlp
from .common import embed_init, rms_norm, split_keys


# --------------------------------------------------------------- structure
def block_kind(cfg, j: int) -> tuple[str, str | None]:
    """(mixer, ffn) type names for period position j."""
    if cfg.family == "ssm":
        mixer = "slstm" if cfg.is_slstm_layer(j) else "mlstm"
        return mixer, None
    mixer = ("mla" if cfg.mla else "gqa") if cfg.is_attn_layer(j) else "mamba"
    ffn = "moe" if cfg.is_moe_layer(j) else "swiglu"
    return mixer, ffn


def _dense_only(cfg, j: int) -> None:
    if block_kind(cfg, j) != ("gqa", "swiglu"):
        raise NotImplementedError(
            f"block {block_kind(cfg, j)} of {cfg.name!r} is not ported; the "
            "port has the dense GQA decoder (ROADMAP item 13c)")


def init_block(key, cfg, j: int) -> dict:
    _dense_only(cfg, j)
    ks = split_keys(key, 2)
    dev = key.device
    return {
        "norm1": torch.ones(cfg.d_model, device=dev),
        "attn": attn.init_gqa(ks[0], cfg),
        "norm2": torch.ones(cfg.d_model, device=dev),
        "ffn": mlp.init_swiglu(ks[1], cfg.d_model, cfg.d_ff, cfg.n_layers),
    }


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return tree[i]


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
    _dense_only(cfg, j)
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
def apply_block_seq(cfg, p, j: int, h, positions, *, q_chunk, kv_chunk,
                    skip_masked_blocks=False):
    """A dense block (the only kind ``init_block`` makes)."""
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + attn.gqa_train(cfg, p["attn"], hn, positions, q_chunk=q_chunk,
                           kv_chunk=kv_chunk,
                           skip_masked_blocks=skip_masked_blocks)
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + mlp.swiglu(p["ffn"], hn)


def apply_block_prefill(cfg, p, j, h, positions, cache_len, *, q_chunk,
                        kv_chunk, skip_masked_blocks=False):
    """Like seq but also returns the cache for serving."""
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    mix, cache = attn.gqa_prefill(cfg, p["attn"], hn, positions, cache_len,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk,
                                  skip_masked_blocks=skip_masked_blocks)
    h = h + mix
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + mlp.swiglu(p["ffn"], hn), cache


def apply_block_decode(cfg, p, j, h, pos: int, cache):
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    mix, cache = attn.gqa_decode(cfg, p["attn"], hn, pos, cache)
    h = h + mix
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + mlp.swiglu(p["ffn"], hn), cache


# ----------------------------------------------------------------- forward
def embed_tokens(cfg, params, tokens, dtype):
    # gather first, cast after: avoids materializing a casted copy of the
    # full (V, D) table per step
    return params["embed"]["table"][tokens].to(dtype)


def unembed_matrix(cfg, params):
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"])


def _periods(cfg, params):
    """Each period's parameters: layer i's slice of every stacked leaf."""
    return [_index(params["layers"], i)
            for i in range(cfg.n_layers // cfg.layer_period)]


def forward_seq(cfg, params, h, positions, *, q_chunk: int = 1024,
                kv_chunk: int = 1024, skip_masked_blocks: bool = False):
    """Body of full-sequence passes: h (B, S, D) -> final hidden."""
    for period_params in _periods(cfg, params):
        for j in range(cfg.layer_period):
            h = apply_block_seq(cfg, period_params[f"pos{j}"], j, h,
                                positions, q_chunk=q_chunk,
                                kv_chunk=kv_chunk,
                                skip_masked_blocks=skip_masked_blocks)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def forward_prefill(cfg, params, h, positions, cache_len, *, q_chunk=1024,
                    kv_chunk=1024, skip_masked_blocks=False):
    per = {f"pos{j}": [] for j in range(cfg.layer_period)}
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
