"""GQA attention (``repro/models/attention.py``'s dense part in PyTorch):
the blockwise (flash-style) train/prefill path and the cached decode path.

The train/prefill path runs the reference's online softmax over
(q_chunk, kv_chunk) blocks with float32 running (m, l, acc), so live
scores stay at one block. The reference has no attention kernel (it is
plain XLA), so this is plain PyTorch too, with the reference's mixed
precision: block scores from the operands cast to float32 (products of
bfloat16 values are exact in float32), probabilities cast to the value
dtype before the PV product, which also sums in float32. Decode forms its
scores in the operand dtype and casts them up after, as the reference
does.

In training each (q, kv) block is checkpointed (non-reentrant), as the
reference wraps its block in ``jax.checkpoint``: the backward pass
recomputes the block's scores and probabilities instead of keeping every
block's, and the q chunks' outputs are joined with ``torch.cat``.

GQA layout: q is grouped as (B, S, KVH, G, dh), so no repeated K/V is
materialized. Mesh islands (sequence-parallel attention, the decode
island) are ROADMAP item 13d.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import rotary
from .common import dense_init, split_keys

_NEG_INF = -1e30


# --------------------------------------------------------------------------
# blockwise attention core
# --------------------------------------------------------------------------
def _block(m_run, l_run, acc, qb, kb, vb, q_pos, kv_pos, scale: float,
           v_dtype: torch.dtype):
    """One (q, kv) block of the online softmax: the running (m, l, acc)
    after it. ``q_pos`` / ``kv_pos`` are None without the causal mask."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
    if q_pos is not None:
        s = torch.where(q_pos[:, None] >= kv_pos[None, :], s, _NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_run - m_new)
    l_run = l_run * corr + p.sum(dim=-1)
    # the reference rounds p to the value dtype before the product
    p = p.to(v_dtype).float()
    acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
    return m_new, l_run, acc


def blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, q_offset: int = 0,
                   q_chunk: int = 1024, kv_chunk: int = 1024,
                   skip_masked_blocks: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, KVH, dh) -> (B, Sq, H, dh).

    ``skip_masked_blocks`` skips the KV blocks a causal mask hides
    entirely (about half the products); the numbers do not change."""
    B, Sq, H, dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KVH
    qc, kvc = min(q_chunk, Sq), min(kv_chunk, Skv)
    if Sq % qc:      # non-divisible (odd test shapes): single chunk
        qc = Sq
    if Skv % kvc:
        kvc = Skv
    nq, nkv = Sq // qc, Skv // kvc
    scale = dh ** -0.5
    dev = q.device
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    qf = q.float().reshape(B, Sq, KVH, G, dh)
    kf = k.float()
    vf = v.float()
    outs = []
    for iq in range(nq):
        qb = qf[:, iq * qc:(iq + 1) * qc]          # (B, qc, KVH, G, dh)
        q_pos = q_offset + iq * qc + torch.arange(qc, device=dev)
        m_run = torch.full((B, KVH, G, qc), _NEG_INF, device=dev)
        l_run = torch.zeros((B, KVH, G, qc), device=dev)
        acc = torch.zeros((B, KVH, G, qc, dv), device=dev)
        for ikv in range(nkv):
            # a block is fully masked iff its first kv pos > last q pos
            if (causal and skip_masked_blocks
                    and ikv * kvc > q_offset + iq * qc + qc - 1):
                continue
            kv_pos = ikv * kvc + torch.arange(kvc, device=dev)
            args = (m_run, l_run, acc, qb, kf[:, ikv * kvc:(ikv + 1) * kvc],
                    vf[:, ikv * kvc:(ikv + 1) * kvc],
                    q_pos if causal else None, kv_pos if causal else None,
                    scale, v.dtype)
            m_run, l_run, acc = (checkpoint(_block, *args,
                                            use_reentrant=False)
                                 if remat else _block(*args))
        o = acc / l_run.clamp_min(1e-30)[..., None]  # (B, KVH, G, qc, dv)
        outs.append(o.permute(0, 3, 1, 2, 4))
    out = outs[0] if nq == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, dv).to(q.dtype)


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """Single-token attention over a cache.

    q: (B, 1, H, dh); caches: (B, S, KVH, dh); valid_len: int or (B,)
    tensor. Scores in the operand dtype, then float32, as the reference.
    """
    B, _, H, dh = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qr = q.reshape(B, KVH, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache).float() * dh ** -0.5
    pos = torch.arange(S, device=q.device)
    if isinstance(valid_len, torch.Tensor):
        mask = pos[None, :] < valid_len.to(q.device).reshape(-1, 1)  # (B, S)
    else:
        # a Python int stays on the host: no copy, so no stream sync
        mask = (pos < int(valid_len))[None, :]        # (1, S)
    s = torch.where(mask[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, dh).to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------
def init_gqa(key, cfg) -> dict:
    D, H, KVH, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = split_keys(key, 4)
    p = {
        "wq": dense_init(ks[0], D, H * dh),
        "wk": dense_init(ks[1], D, KVH * dh),
        "wv": dense_init(ks[2], D, KVH * dh),
        "wo": dense_init(ks[3], H * dh, D,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.use_bias:
        z = lambda n: torch.zeros(n, device=key.device)  # noqa: E731
        p.update(bq=z(H * dh), bk=z(KVH * dh), bv=z(KVH * dh),
                 bo=z(D))
    return p


def gqa_qkv(cfg, p, x, positions):
    """Project + rotate. x: (B, S, D); positions: (B, S); ``p`` holds the
    weights in x's dtype."""
    B, S, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KVH, dh)
    v = v.reshape(B, S, KVH, dh)
    q = rotary.apply_rope(q, positions, cfg.rope_theta)
    k = rotary.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_out(cfg, p, attn_out):
    B, S = attn_out.shape[:2]
    out = attn_out.reshape(B, S, -1) @ p["wo"]
    if cfg.use_bias:
        out = out + p["bo"]
    return out


def gqa_train(cfg, p, x, positions, *, q_chunk=1024, kv_chunk=1024,
              skip_masked_blocks=False):
    q, k, v = gqa_qkv(cfg, p, x, positions)
    o = blockwise_attn(q, k, v, q_chunk=q_chunk,
                       kv_chunk=kv_chunk,
                       skip_masked_blocks=skip_masked_blocks)
    return gqa_out(cfg, p, o)


def gqa_prefill(cfg, p, x, positions, cache_len, *, q_chunk=1024,
                kv_chunk=1024, skip_masked_blocks=False):
    """Returns (out, (k_cache, v_cache)): caches zero-padded to
    cache_len."""
    q, k, v = gqa_qkv(cfg, p, x, positions)
    o = blockwise_attn(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk,
                       skip_masked_blocks=skip_masked_blocks)
    pad = cache_len - x.shape[1]
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return gqa_out(cfg, p, o), (k, v)


def gqa_decode(cfg, p, x, pos: int, cache):
    """One-token step. x: (B, 1, D); pos: the current index; cache:
    (k, v) each (B, S_max, KVH, dh). Row ``pos`` of the cache is written
    in place (the reference's dynamic_update_slice); returns (out,
    cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_qkv(cfg, p, x, positions)
    k_cache, v_cache = cache
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    o = decode_attn(q, k_cache, v_cache, pos + 1)
    return gqa_out(cfg, p, o), (k_cache, v_cache)
