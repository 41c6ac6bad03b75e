"""The decoder stack of the dense, MoE, MLA, Jamba-hybrid, xLSTM and VLM
families (``repro/models/transformer.py`` in PyTorch); the VLM's blocks
are GQA blocks whose positions are M-RoPE's (3, B, S) streams.

Layers are grouped into periods (``cfg.layer_period``): within a period
the block kinds may differ (Jamba: 7 Mamba + 1 attention; xLSTM: 5 mLSTM +
1 sLSTM), across periods they repeat. Parameters are stacked over periods
as in the reference: every leaf under ``params["layers"]["pos{j}"]`` has a
leading (n_layers / period) axis, so the reference's tree carries across
leaf by leaf. The stack runs as a Python loop over periods, each taking
its slice of every stacked leaf (``torch.unbind``, whose backward stacks
the slices' gradients). Caches are stacked the same way: the attention
caches (GQA's K / V, MLA's latent) have each new row written in place by
decode, and the recurrent states (Mamba's h and conv window, mLSTM's C, n,
m, sLSTM's c, n, h, m) are replaced in place by each step's new state.

The apply functions take the parameter tree in the compute dtype, with
the leaves the reference reads in float32 left float32
(``_keeps_float32``). Serving hands them the model's cast copy
(``Model.compute_params``); training hands ``forward_seq`` the float32
masters with ``cast=dtype``, and each block's slice is cast at its use
inside the autograd graph, as the reference casts with ``.astype`` at
each use, so the gradients land on the float32 leaves. ``remat=True``
recomputes each period in the backward pass (``torch.utils.checkpoint``,
non-reentrant);
``remat_policy="dots"`` keeps the outputs of the matrix products
(selective activation checkpointing), as the reference's
``checkpoint_dots``. Mamba and mLSTM checkpoint each chunk whenever
autograd records through their input, as the reference does whatever
``remat`` is.

On a mesh (``rows``: this rank's layout, ``sharding/layout.py``) the
activations between blocks are this rank's rows: the batch over the
data-parallel axes and the sequence over 'model' where each divides (the
reference's ``shard_batch`` at every block edge, here kept by every
block). Norms, projections, the MLP and the loss run on those rows. Each
block's parameters arrive as this rank's blocks and are cast, then
gathered, at their use (``Rows.params``), inside the checkpointed period
when it records. Attention is the sequence-parallel island; Mamba's conv
and scan, mLSTM and sLSTM gather their block input over 'model', run on
the whole sequence and keep their own rows; the MoE runs its island.
Decode caches: GQA's and MLA's by ``attention.cache_seq_axes``; the
recurrent states batch over DP and whole over 'model' (the reference's
decode does not constrain them), so every model rank steps the same
state.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import mamba as mb
from . import mlp
from . import xlstm as xl
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


def init_block(key, cfg, j: int) -> dict:
    mixer, ffn = block_kind(cfg, j)
    ks = split_keys(key, 2)
    dev = key.device
    p: dict[str, Any] = {"norm1": torch.ones(cfg.d_model, device=dev)}
    if mixer == "gqa":
        p["attn"] = attn.init_gqa(ks[0], cfg)
    elif mixer == "mla":
        p["attn"] = attn.init_mla(ks[0], cfg)
    elif mixer == "mamba":
        p["mamba"] = mb.init_mamba(ks[0], cfg)
    elif mixer == "mlstm":
        p["mlstm"] = xl.init_mlstm(ks[0], cfg)
    else:
        p["slstm"] = xl.init_slstm(ks[0], cfg)
    if ffn is not None:
        p["norm2"] = torch.ones(cfg.d_model, device=dev)
        if ffn == "moe":
            p["moe"] = mlp.init_moe(ks[1], cfg)
        else:
            p["ffn"] = mlp.init_swiglu(ks[1], cfg.d_model, cfg.d_ff,
                                       cfg.n_layers)
    return p


# Leaves some apply function reads in float32 (``.astype(jnp.float32)`` of
# the float32 master in the reference): a copy cast to bfloat16 and back
# would not be the master. The MoE router; Mamba's A and, in decode, its
# conv and skip; mLSTM's gate bias; sLSTM's recurrent weights and gate
# bias. Where the reference casts one of them to the compute dtype, the
# apply function casts it at that use.
_FLOAT32_LEAVES = frozenset(("router", "a_log", "conv_w", "conv_bias",
                             "d_skip", "b_if", "r_gates", "b_gates"))


def _keeps_float32(name: str) -> bool:
    """Leaves the apply functions read in float32: norm scales (cast at
    their use where the reference casts them) and ``_FLOAT32_LEAVES``."""
    return "norm" in name or name in _FLOAT32_LEAVES


def _is_layer_norm(v) -> bool:
    """A LayerNorm's parameters ({"scale", "bias"}: the encoder-decoder's
    ``norm1``, ``norm_x``, ``enc_final``, ...). ``layer_norm`` reads both
    in float32, and their own keys do not say "norm", so the rule goes by
    the subtree."""
    return isinstance(v, dict) and set(v) == {"scale", "bias"}


def cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """The tree in the compute dtype, norm scales, LayerNorms' scales and
    biases and ``_FLOAT32_LEAVES`` left float32; differentiable (the
    model's serving copy detaches first)."""
    return {k: (v if _is_layer_norm(v) else cast_tree(v, dtype)
                if isinstance(v, dict)
                else v if _keeps_float32(k) else v.to(dtype))
            for k, v in tree.items()}


def _stack(trees: list) -> Any:
    """The trees stacked leaf by leaf on a new leading axis. Each leaf is
    taken out of its tree as it is stacked, so no more than one leaf is
    held twice; one tree's leaves become views."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    return trees[0][None] if len(trees) == 1 else torch.stack(trees)


def _unstack(tree, n: int) -> list:
    """The n slices of a tree stacked on its leading axis."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def _whole(path: str, x, *, stacked: bool = False):
    return x


def keep_tree(tree: dict, prefix: str, keep, stacked: bool = True) -> dict:
    """``keep(path, leaf, stacked=)`` of each leaf of a tree at ``prefix``
    (``stacked``: one layer's tree, each leaf the layer's part of the
    stacked leaf ``path``), the tree emptied as it goes."""
    return {k: keep_tree(v, f"{prefix}/{k}", keep, stacked)
            if isinstance(v, dict)
            else keep(f"{prefix}/{k}", v, stacked=stacked)
            for k, v in ((k, tree.pop(k)) for k in list(tree))}


def init_decoder(key, cfg, *, with_embed: bool = True,
                 keep=_whole) -> dict:
    """The reference's parameters for this key. ``keep(path, leaf,
    stacked=)`` maps each leaf as it is drawn, one layer at a time, to
    what the tree holds (a mesh rank's block: ``Layout.keep``), so no
    more than one layer is held whole."""
    period = cfg.layer_period
    n_periods = cfg.n_layers // period
    if cfg.n_layers % period:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the "
                         f"period {period}")
    keys = split_keys(key, 3 + cfg.n_layers)
    params: dict[str, Any] = {}
    if with_embed:
        params["embed"] = {"table": keep(
            "embed/table", embed_init(keys[0], cfg.vocab, cfg.d_model))}
        if not cfg.tie_embeddings:
            params["unembed"] = keep("unembed", embed_init(
                keys[1], cfg.vocab, cfg.d_model))
    layers: dict[str, Any] = {}
    for j in range(period):
        layers[f"pos{j}"] = _stack([
            keep_tree(init_block(keys[3 + i * period + j], cfg, j),
                      f"layers/pos{j}", keep) for i in range(n_periods)])
    params["layers"] = layers
    params["final_norm"] = keep("final_norm", torch.ones(cfg.d_model,
                                                         device=key.device))
    return params


# ------------------------------------------------------------------ caches
def init_block_cache(cfg, j: int, batch: int, cache_len: int, dtype,
                     device=None, rows=None):
    """Block j's zero cache; on a mesh this rank's shard (``rows``: the
    batch's layout; the attention caches' sequence by
    ``attention.cache_seq_axes``)."""
    mixer, _ = block_kind(cfg, j)
    z = functools.partial(torch.zeros, dtype=dtype, device=device)
    if rows is not None:
        batch = rows.B_l
        axes = attn.cache_seq_axes(rows, cache_len, two_d=mixer == "gqa")
        cache_len //= rows.lay.size(axes) if axes else 1
    if mixer == "gqa":
        kv = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return (z(kv), z(kv))
    if mixer == "mla":
        return (z((batch, cache_len, cfg.kv_lora_rank)),
                z((batch, cache_len, cfg.qk_rope_dim)))
    if mixer == "mamba":
        return mb.mamba_init_state(cfg, batch, dtype, device)
    if mixer == "mlstm":
        return xl.mlstm_init_state(cfg, batch, device)
    return xl.slstm_init_state(cfg, batch, device)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of caches: tuples and dicts of tensors."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, tuple):
        return tuple(_tree_map(fn, *u) for u in zip(*trees))
    return fn(*trees)


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None, rows=None) -> dict:
    """{"pos{j}": the block's cache}, every leaf with a leading
    n_periods axis: real zeros (or ones), not a broadcast view, since
    decode writes in place."""
    period = cfg.layer_period
    n_periods = cfg.n_layers // period
    return {f"pos{j}": _tree_map(
        lambda x: x[None].repeat((n_periods,) + (1,) * x.dim()),
        init_block_cache(cfg, j, batch, cache_len, dtype, device, rows))
        for j in range(period)}


# ------------------------------------------------------------- block apply
def _ffn(cfg, p, h, rows=None, j: int = 0):
    """The block's FFN on the residual h (none for xLSTM's blocks)."""
    if "norm2" not in p:
        return h
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        return h + mlp.moe_apply(cfg, p["moe"], hn, rows=rows,
                                 path=f"layers/pos{j}/moe")
    return h + mlp.swiglu(p["ffn"], hn)


def _whole_seq(rows, fn, hn):
    """A sequence mixer that needs the whole sequence: its input gathered
    over 'model', its output cut back to this rank's rows (its state, if
    it returns one, kept whole)."""
    if rows is None:
        return fn(hn)
    out = fn(rows.gather_seq(hn))
    if isinstance(out, tuple):
        return (rows.own_seq(out[0]),) + out[1:]
    return rows.own_seq(out)


def apply_block_seq(cfg, p, j: int, h, positions, *, q_chunk, kv_chunk,
                    ssm_chunk=256, skip_masked_blocks=False, rows=None):
    mixer, _ = block_kind(cfg, j)
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    if mixer == "gqa":
        mix = attn.gqa_train(cfg, p["attn"], hn, positions, q_chunk=q_chunk,
                             kv_chunk=kv_chunk,
                             skip_masked_blocks=skip_masked_blocks,
                             rows=rows)
    elif mixer == "mla":
        mix = attn.mla_train(cfg, p["attn"], hn, positions, q_chunk=q_chunk,
                             kv_chunk=kv_chunk,
                             skip_masked_blocks=skip_masked_blocks,
                             rows=rows)
    elif mixer == "mamba":
        mix = _whole_seq(rows, lambda x: mb.mamba_seq(
            cfg, p["mamba"], x, chunk=ssm_chunk), hn)
    elif mixer == "mlstm":
        mix = _whole_seq(rows, lambda x: xl.mlstm_seq(
            cfg, p["mlstm"], x, chunk=ssm_chunk), hn)
    else:
        mix = _whole_seq(rows, lambda x: xl.slstm_seq(cfg, p["slstm"], x),
                         hn)
    return _ffn(cfg, p, h + mix, rows, j)


def apply_block_prefill(cfg, p, j, h, positions, cache_len, *, q_chunk,
                        kv_chunk, ssm_chunk=256, skip_masked_blocks=False,
                        rows=None):
    """Like seq but also returns the cache for serving."""
    mixer, _ = block_kind(cfg, j)
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk,
              skip_masked_blocks=skip_masked_blocks, rows=rows)
    if mixer == "gqa":
        mix, cache = attn.gqa_prefill(cfg, p["attn"], hn, positions,
                                      cache_len, **kw)
    elif mixer == "mla":
        mix, cache = attn.mla_prefill(cfg, p["attn"], hn, positions,
                                      cache_len, **kw)
    elif mixer == "mamba":
        mix, cache = _whole_seq(rows, lambda x: mb.mamba_prefill(
            cfg, p["mamba"], x, ssm_chunk), hn)
    elif mixer == "mlstm":
        mix, cache = _whole_seq(rows, lambda x: xl.mlstm_prefill(
            cfg, p["mlstm"], x, ssm_chunk), hn)
    else:
        mix, cache = _whole_seq(rows, lambda x: xl.slstm_prefill(
            cfg, p["slstm"], x), hn)
    return _ffn(cfg, p, h + mix, rows, j), cache


def apply_block_decode(cfg, p, j, h, pos: int, cache, rows=None,
                       cache_len: int = 0):
    mixer, _ = block_kind(cfg, j)
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    if mixer == "gqa":
        mix, cache = attn.gqa_decode(cfg, p["attn"], hn, pos, cache,
                                     rows=rows, cache_len=cache_len)
    elif mixer == "mla":
        mix, cache = attn.mla_decode(cfg, p["attn"], hn, pos, cache,
                                     rows=rows, cache_len=cache_len)
    elif mixer == "mamba":
        mix, cache = mb.mamba_decode(cfg, p["mamba"], hn, cache)
    elif mixer == "mlstm":
        mix, cache = xl.mlstm_decode(cfg, p["mlstm"], hn, cache)
    else:
        mix, cache = xl.slstm_decode(cfg, p["slstm"], hn, cache)
    return _ffn(cfg, p, h + mix, rows, j), cache


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


def _block_params(pp, j: int, cast, rows=None):
    """Block j's slice of a period, cast to ``cast`` (when given) here, at
    its use: no cast copy of more than one block is held at a time. On a
    mesh the cast blocks are then gathered (``Rows.params``)."""
    p = pp[f"pos{j}"]
    p = p if cast is None else cast_tree(p, cast)
    if rows is None:
        return p
    return rows.params(p, f"layers/pos{j}",
                       skip=[f"moe/{k}" for k in mlp.EXPERT_STACKS])


def final_norm(cfg, params, h, rows=None):
    w = params["final_norm"]
    return rms_norm(h, w if rows is None else rows.leaf(w, "final_norm"),
                    cfg.norm_eps)


def forward_seq(cfg, params, h, positions, *, q_chunk: int = 1024,
                kv_chunk: int = 1024, ssm_chunk: int = 256,
                skip_masked_blocks: bool = False, remat: bool = False,
                remat_policy: str = "nothing",
                cast: torch.dtype | None = None, rows=None):
    """Body of full-sequence passes: h (B, S, D) -> final hidden (on a
    mesh: this rank's rows of both).

    ``cast``: the layers' parameters are float32 masters, each block's
    cast to this dtype at its use (inside the autograd graph when it
    records). ``remat``: checkpoint each period (when autograd records),
    keeping what ``remat_policy`` names: 'nothing' (the period's input
    only) or 'dots' (also the products' outputs)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                         f"{REMAT_POLICIES}")

    def period(h, pp):
        for j in range(cfg.layer_period):
            h = apply_block_seq(cfg, _block_params(pp, j, cast, rows), j, h,
                                positions, q_chunk=q_chunk,
                                kv_chunk=kv_chunk, ssm_chunk=ssm_chunk,
                                skip_masked_blocks=skip_masked_blocks,
                                rows=rows)
        return h

    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    remat = remat and torch.is_grad_enabled()
    for pp in _periods(cfg, params):
        h = (checkpoint(period, h, pp, use_reentrant=False, **kw) if remat
             else period(h, pp))
    return final_norm(cfg, params, h, rows)


def forward_prefill(cfg, params, h, positions, cache_len, *, q_chunk=1024,
                    kv_chunk=1024, ssm_chunk=256, skip_masked_blocks=False,
                    cast: torch.dtype | None = None, rows=None):
    per: dict = {f"pos{j}": [] for j in range(cfg.layer_period)}
    for pp in _periods(cfg, params):
        for j in range(cfg.layer_period):
            h, cache = apply_block_prefill(
                cfg, _block_params(pp, j, cast, rows), j, h, positions,
                cache_len, q_chunk=q_chunk, kv_chunk=kv_chunk,
                ssm_chunk=ssm_chunk, skip_masked_blocks=skip_masked_blocks,
                rows=rows)
            per[f"pos{j}"].append(cache)
    caches = {name: _tree_map(lambda *xs: torch.stack(xs), *cs)
              for name, cs in per.items()}
    return final_norm(cfg, params, h, rows), caches


def _write(dst, src) -> None:
    """The new cache or state ``src`` into its stacked slot ``dst``; the
    attention caches are already written in place (src is dst)."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _write(d, s)
    elif src is not dst:
        dst.copy_(src)


def forward_decode(cfg, params, h, pos: int, caches,
                   cast: torch.dtype | None = None, rows=None,
                   cache_len: int = 0):
    """One token through the stack. Each layer's cache is updated in
    place (row ``pos`` of an attention cache, the whole state of a
    recurrent block), and ``caches`` is returned. On a mesh the caches
    are this rank's shards of ``cache_len`` caches."""
    for i, pp in enumerate(_periods(cfg, params)):
        for j in range(cfg.layer_period):
            mine = _tree_map(lambda x: x[i], caches[f"pos{j}"])
            h, new = apply_block_decode(cfg, _block_params(pp, j, cast, rows),
                                        j, h, pos, mine, rows, cache_len)
            _write(mine, new)
    return final_norm(cfg, params, h, rows), caches
