"""Whisper-style encoder-decoder backbone (arXiv:2212.04356;
``repro/models/encdec.py`` in PyTorch).

The conv audio frontend is a stub, as in the reference: inputs are
precomputed frame embeddings (B, enc_seq, D). The encoder is
bidirectional self-attention; the decoder adds causal self-attention with
a KV cache and cross-attention whose K / V are computed once from the
encoder output and cached (``xk`` / ``xv``, (L, B, enc_seq, H, dh)) for
decode. LayerNorm, the tanh GELU MLP with biases and learned positions
(a 40,960-row ``pos_table``, an ``enc_seq``-row ``enc_pos_table``), no
RoPE.

Blocks are stacked as the reference's ``enc_blocks`` / ``dec_blocks`` (a
leading layer axis on every leaf), so its tree carries across leaf by
leaf, and run as a Python loop over the layers' slices. The attention
chunks are the reference's: the encoder and the cross-attention take
``min(1024, S)``, which at whisper's 1,500 frames divides nothing, so
both run one 1,500-row chunk. Decode writes row ``pos`` of each layer's
self-attention cache in place.

The apply functions take the parameter tree in the compute dtype (the
LayerNorms float32: ``transformer.cast_tree``), or the float32 masters
with ``cast=dtype``: each block's slice is then cast at its use, inside
the autograd graph when it records. ``decode_seq(remat=True)``
checkpoints each decoder block (``torch.utils.checkpoint``,
non-reentrant), as the reference's ``jax.checkpoint`` of its scan body;
the encoder is not checkpointed, as in the reference.

On a mesh (``rows``, ``sharding/layout.py``) the encoder's and the
decoder's activations are this rank's rows (batch over DP, sequence over
'model' where each divides); each block's parameters are gathered at
their use. Both self-attentions are the sequence-parallel island
(bidirectional in the encoder); ``encode`` hands back its output
gathered over 'model', the whole sequence of this rank's batch rows,
which every cross-attention reads. The self-attention caches are held as
GQA's (``attention.cache_seq_axes``), the cross caches batch over DP and
whole over 'model'.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import mlp
from .common import dense_init, embed_init, layer_norm, split_keys
from .transformer import _stack, _unstack, _whole, cast_tree, keep_tree

POS_ROWS = 40_960       # the decoder's learned positions (the reference's)
CACHE_KEYS = ("k", "v", "xk", "xv")     # a decoder layer's cache entries


def _init_norm(d: int, device=None) -> dict:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def init_cross(key, cfg) -> dict:
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    ks = split_keys(key, 4)
    dev = key.device
    return {
        "wq": dense_init(ks[0], D, H * dh),
        "wk": dense_init(ks[1], D, H * dh),
        "wv": dense_init(ks[2], D, H * dh),
        "wo": dense_init(ks[3], H * dh, D),
        "bq": torch.zeros(H * dh, device=dev),
        "bo": torch.zeros(D, device=dev),
    }


def cross_kv(cfg, p, memory):
    """Cross-attention K / V from the encoder output (B, Se, D)."""
    B, Se, _ = memory.shape
    H, dh = cfg.n_heads, cfg.head_dim
    k = (memory @ p["wk"]).reshape(B, Se, H, dh)
    v = (memory @ p["wv"]).reshape(B, Se, H, dh)
    return k, v


def _cross_q(cfg, p, x):
    B, S, _ = x.shape
    return (x @ p["wq"] + p["bq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)


def _cross_out(p, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"] + p["bo"]


def cross_attend(cfg, p, x, k, v):
    q = _cross_q(cfg, p, x)
    o = attn.blockwise_attn(q, k, v, causal=False,
                            q_chunk=min(1024, x.shape[1]),
                            kv_chunk=min(1024, k.shape[1]))
    return _cross_out(p, o)


def init_enc_layer(key, cfg) -> dict:
    ks = split_keys(key, 2)
    dev = key.device
    return {
        "norm1": _init_norm(cfg.d_model, dev),
        "attn": attn.init_gqa(ks[0], cfg),
        "norm2": _init_norm(cfg.d_model, dev),
        "ffn": mlp.init_gelu_mlp(ks[1], cfg.d_model, cfg.d_ff,
                                 cfg.n_enc_layers, use_bias=True),
    }


def init_dec_layer(key, cfg) -> dict:
    ks = split_keys(key, 3)
    dev = key.device
    return {
        "norm1": _init_norm(cfg.d_model, dev),
        "attn": attn.init_gqa(ks[0], cfg),
        "norm_x": _init_norm(cfg.d_model, dev),
        "cross": init_cross(ks[1], cfg),
        "norm2": _init_norm(cfg.d_model, dev),
        "ffn": mlp.init_gelu_mlp(ks[2], cfg.d_model, cfg.d_ff,
                                 cfg.n_layers, use_bias=True),
    }


def init_encdec(key, cfg, *, keep=_whole) -> dict:
    """The reference's parameters for this key: keys 0-2 the tables, 3-5
    unused, then one a layer, encoder first. ``keep``: as
    ``transformer.init_decoder``'s, one layer at a time."""
    ks = split_keys(key, 6 + cfg.n_enc_layers + cfg.n_layers)
    dev = key.device
    top = {
        "embed": {"table": embed_init(ks[0], cfg.vocab, cfg.d_model)},
        "pos_table": embed_init(ks[1], POS_ROWS, cfg.d_model),
        "enc_pos_table": embed_init(ks[2], cfg.enc_seq, cfg.d_model),
        "enc_final": _init_norm(cfg.d_model, dev),
        "final_norm": _init_norm(cfg.d_model, dev),
    }
    params: dict[str, Any] = {
        k: keep_tree(v, k, keep, stacked=False) if isinstance(v, dict)
        else keep(k, v) for k, v in top.items()}
    del top
    params["enc_blocks"] = _stack([
        keep_tree(init_enc_layer(ks[6 + i], cfg), "enc_blocks", keep)
        for i in range(cfg.n_enc_layers)])
    params["dec_blocks"] = _stack([
        keep_tree(init_dec_layer(ks[6 + cfg.n_enc_layers + i], cfg),
                  "dec_blocks", keep) for i in range(cfg.n_layers)])
    return params


def _at_use(p, cast, rows, prefix):
    """A layer's slice cast to ``cast`` (when given), then gathered (on a
    mesh)."""
    p = p if cast is None else cast_tree(p, cast)
    return p if rows is None else rows.params(p, prefix)


def _layers(blocks: dict, n: int, cast, rows=None, prefix=""):
    """Each layer's slice of the stacked blocks, cast to ``cast`` (when
    given) at its use."""
    for p in _unstack(blocks, n):
        yield _at_use(p, cast, rows, prefix)


def _leaf(params, name, rows):
    """An unstacked leaf or LayerNorm at use."""
    v = params[name]
    if rows is None:
        return v
    if isinstance(v, dict):
        return rows.params(v, name, stacked=False)
    return rows.leaf(v, name)


def _pos_rows(table, rows, start: int, n: int):
    """Rows ``start .. start + n`` of a positions table, this rank's part
    of them on a mesh."""
    if rows is not None:
        start, n = start + rows.s0, rows.S_l
    return table[start:start + n]


# ---------------------------------------------------------------- blocks
def enc_block(cfg, p, h, rows=None):
    """One encoder block: bidirectional self-attention, then the MLP."""
    Se = h.shape[1] if rows is None else rows.S
    hn = _ln(h, p["norm1"], cfg.norm_eps)
    h = h + attn.gqa_train(cfg, p["attn"], hn, None, rope=False,
                           causal=False, q_chunk=min(1024, Se),
                           kv_chunk=min(1024, Se), rows=rows)
    hn = _ln(h, p["norm2"], cfg.norm_eps)
    return h + mlp.gelu_mlp(p["ffn"], hn)


def _dec_tail(cfg, p, h, xk, xv):
    """The cross-attention over (xk, xv) and the MLP of a decoder block."""
    hn = _ln(h, p["norm_x"], cfg.norm_eps)
    h = h + cross_attend(cfg, p["cross"], hn, xk, xv)
    hn = _ln(h, p["norm2"], cfg.norm_eps)
    return h + mlp.gelu_mlp(p["ffn"], hn)


def dec_block_seq(cfg, p, h, memory, *, q_chunk=1024, kv_chunk=1024,
                  rows=None):
    """One decoder block over the whole sequence (training)."""
    S = h.shape[1] if rows is None else rows.S
    hn = _ln(h, p["norm1"], cfg.norm_eps)
    h = h + attn.gqa_train(cfg, p["attn"], hn, None, rope=False, causal=True,
                           q_chunk=min(q_chunk, S), kv_chunk=min(kv_chunk, S),
                           rows=rows)
    return _dec_tail(cfg, p, h, *cross_kv(cfg, p["cross"], memory))


def dec_block_prefill(cfg, p, h, memory, cache_len: int, *, q_chunk=1024,
                      kv_chunk=1024, rows=None):
    """One decoder block over the prompt; returns (h, (k, v, xk, xv)):
    the self-attention's K / V zero-padded to ``cache_len`` and the
    cross-attention's K / V of the encoder output."""
    S = h.shape[1] if rows is None else rows.S
    hn = _ln(h, p["norm1"], cfg.norm_eps)
    o, (k, v) = attn.gqa_prefill(cfg, p["attn"], hn, None, cache_len,
                                 q_chunk=min(q_chunk, S),
                                 kv_chunk=min(kv_chunk, S), rope=False,
                                 rows=rows)
    h = h + o
    xk, xv = cross_kv(cfg, p["cross"], memory)
    return _dec_tail(cfg, p, h, xk, xv), (k, v, xk, xv)


def dec_block_decode(cfg, p, h, pos: int, cache, rows=None,
                     cache_len: int = 0):
    """One decoder block for one token at index ``pos``; cache: (k, v, xk,
    xv), row ``pos`` of k and v written in place. Returns (h, cache)."""
    k_c, v_c, xk, xv = cache
    hn = _ln(h, p["norm1"], cfg.norm_eps)
    o, _ = attn.gqa_decode(cfg, p["attn"], hn, pos, (k_c, v_c), rope=False,
                           rows=rows, cache_len=cache_len)
    h = h + o
    hn = _ln(h, p["norm_x"], cfg.norm_eps)
    o = attn.decode_attn(_cross_q(cfg, p["cross"], hn), xk, xv, xk.shape[1])
    h = h + _cross_out(p["cross"], o)
    hn = _ln(h, p["norm2"], cfg.norm_eps)
    return h + mlp.gelu_mlp(p["ffn"], hn), cache


# ---------------------------------------------------------------- stacks
def encode(cfg, params, frames, *, cast: torch.dtype | None = None,
           rows=None):
    """frames: (B, enc_seq, D) stub embeddings in the compute dtype ->
    (B, enc_seq, D). On a mesh ``frames`` is this rank's rows (``rows``
    over enc_seq) and the output is gathered over 'model'."""
    Se = frames.shape[1] if rows is None else rows.S
    table = _leaf(params, "enc_pos_table", rows)
    h = frames + _pos_rows(table, rows, 0, Se).to(frames.dtype)
    for p in _layers(params["enc_blocks"], cfg.n_enc_layers, cast, rows,
                     "enc_blocks"):
        h = enc_block(cfg, p, h, rows)
    h = _ln(h, _leaf(params, "enc_final", rows), cfg.norm_eps)
    return h if rows is None else rows.gather_seq(h)


def decode_seq(cfg, params, tokens_embed, memory, *, remat: bool = False,
               q_chunk: int = 1024, kv_chunk: int = 1024,
               cast: torch.dtype | None = None, rows=None):
    """Full-sequence decoder pass (training). tokens_embed: (B, S, D)
    (this rank's rows on a mesh)."""
    S = tokens_embed.shape[1] if rows is None else rows.S
    table = _leaf(params, "pos_table", rows)
    h = tokens_embed + _pos_rows(table, rows, 0, S).to(tokens_embed.dtype)

    def block(h, p):
        return dec_block_seq(cfg, _at_use(p, cast, rows, "dec_blocks"), h,
                             memory, q_chunk=q_chunk, kv_chunk=kv_chunk,
                             rows=rows)

    remat = remat and torch.is_grad_enabled()
    for p in _unstack(params["dec_blocks"], cfg.n_layers):
        h = (checkpoint(block, h, p, use_reentrant=False) if remat
             else block(h, p))
    return _ln(h, _leaf(params, "final_norm", rows), cfg.norm_eps)


def init_dec_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    """Zero caches; ``cache_len`` is the self-attention caches' (local)
    length."""
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    kv = (L, batch, cache_len, cfg.n_kv_heads, dh)
    xkv = (L, batch, cfg.enc_seq, H, dh)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return {"k": z(kv), "v": z(kv), "xk": z(xkv), "xv": z(xkv)}


def prefill(cfg, params, tokens_embed, memory, cache_len: int, *,
            q_chunk: int = 1024, kv_chunk: int = 1024,
            cast: torch.dtype | None = None, rows=None):
    """The full-sequence decoder pass that also returns the caches:
    {"k", "v"} (L, B, cache_len, KVH, dh), zero-padded past the prompt,
    and {"xk", "xv"} (L, B, enc_seq, H, dh)."""
    S = tokens_embed.shape[1] if rows is None else rows.S
    table = _leaf(params, "pos_table", rows)
    h = tokens_embed + _pos_rows(table, rows, 0, S).to(tokens_embed.dtype)
    per = []
    for p in _layers(params["dec_blocks"], cfg.n_layers, cast, rows,
                     "dec_blocks"):
        h, cache = dec_block_prefill(cfg, p, h, memory, cache_len,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk,
                                     rows=rows)
        per.append(cache)
    caches = {name: torch.stack(ts) for name, ts in zip(CACHE_KEYS,
                                                         zip(*per))}
    return _ln(h, _leaf(params, "final_norm", rows), cfg.norm_eps), caches


def decode_step(cfg, params, tok_embed, pos: int, caches,
                cast: torch.dtype | None = None, rows=None,
                cache_len: int = 0):
    """One decoder token. tok_embed: (B, 1, D); pos: its index. Row
    ``pos`` of each layer's self-attention cache is written in place;
    returns (final hidden (B, 1, D), caches)."""
    table = _leaf(params, "pos_table", rows)
    h = tok_embed + table[pos:pos + 1].to(tok_embed.dtype)
    for i, p in enumerate(_layers(params["dec_blocks"], cfg.n_layers,
                                  cast, rows, "dec_blocks")):
        h, _ = dec_block_decode(cfg, p, h, pos,
                                tuple(caches[k][i] for k in CACHE_KEYS),
                                rows, cache_len)
    return _ln(h, _leaf(params, "final_norm", rows), cfg.norm_eps), caches
