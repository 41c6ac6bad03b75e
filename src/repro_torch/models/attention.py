"""Attention (``repro/models/attention.py`` in PyTorch): GQA with the
blockwise (flash-style) train/prefill path and the cached decode path, and
DeepSeek-V2's MLA (latent KV) with the absorbed decode.

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
materialized. MLA's q and k are qk_nope + qk_rope wide and its v
v_head_dim wide; the blockwise core scales by q's width and keeps v's.
GQA takes ``rope`` (False under the encoder-decoder's learned
positions) and ``causal`` (False in its encoder), and rotates by M-RoPE's
three streams where ``cfg.mrope``. Mesh islands (sequence-parallel
attention, the decode island) are ROADMAP item 13d.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import rotary
from .common import dense_init, rms_norm, split_keys

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


def gqa_qkv(cfg, p, x, positions, *, rope: bool = True):
    """Project + rotate. x: (B, S, D); positions: (B, S), or (3, B, S)
    streams under M-RoPE (``cfg.mrope``); ``rope=False`` (the
    encoder-decoder's learned positions) leaves q and k unrotated. ``p``
    holds the weights in x's dtype."""
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
    if rope and cfg.mrope:
        q = rotary.apply_mrope(q, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        k = rotary.apply_mrope(k, positions, cfg.rope_theta,
                               cfg.mrope_sections)
    elif rope:
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
              skip_masked_blocks=False, rope=True, causal=True):
    q, k, v = gqa_qkv(cfg, p, x, positions, rope=rope)
    o = blockwise_attn(q, k, v, causal=causal, q_chunk=q_chunk,
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


def gqa_decode(cfg, p, x, pos: int, cache, *, rope: bool = True):
    """One-token step. x: (B, 1, D); pos: the current index, which is
    also the token's position (on all three streams under M-RoPE, as in
    the reference); cache: (k, v) each (B, S_max, KVH, dh). Row ``pos``
    of the cache is written in place (the reference's
    dynamic_update_slice); returns (out, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        positions = positions.expand(3, B, 1)
    q, k_new, v_new = gqa_qkv(cfg, p, x, positions, rope=rope)
    k_cache, v_cache = cache
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    o = decode_attn(q, k_cache, v_cache, pos + 1)
    return gqa_out(cfg, p, o), (k_cache, v_cache)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent KV compression, absorbed decode
# --------------------------------------------------------------------------
def init_mla(key, cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    r, qr_ = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ks = split_keys(key, 6)
    dev = key.device
    p = {
        "wkv_a": dense_init(ks[0], D, r + dr),          # -> [ckv, k_rope]
        "kv_norm": torch.ones(r, device=dev),
        "wkv_b": dense_init(ks[1], r, H * (dn + dv)),   # latent -> k_nope,v
        "wo": dense_init(ks[2], H * dv, D,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if qr_:
        p["wq_a"] = dense_init(ks[3], D, qr_)
        p["q_norm"] = torch.ones(qr_, device=dev)
        p["wq_b"] = dense_init(ks[4], qr_, H * (dn + dr))
    else:
        p["wq"] = dense_init(ks[5], D, H * (dn + dr))
    return p


def _mla_q(cfg, p, x, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, rotary.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg, p, x, positions):
    """ckv (B, S, r) normalized latent + rotated shared k_rope (B, S, 1,
    dr)."""
    r = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    ckv = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = rotary.apply_rope(kv[..., r:][:, :, None, :], positions,
                               cfg.rope_theta)
    return ckv, k_rope


def mla_train(cfg, p, x, positions, *, q_chunk=1024, kv_chunk=1024,
              skip_masked_blocks=False):
    """Training / prefill: the latent expanded to full per-head K / V;
    k_rope is shared by the heads."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    kv = (ckv @ p["wkv_b"]).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], -1)
    o = blockwise_attn(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk,
                       skip_masked_blocks=skip_masked_blocks)
    return o.reshape(B, S, H * dv) @ p["wo"]


def mla_prefill(cfg, p, x, positions, cache_len, **kw):
    """Returns (out, (ckv_cache, k_rope_cache)): the *latent* cache,
    kv_lora_rank + qk_rope_dim values a token instead of H (dn + dv),
    zero-padded to cache_len."""
    out = mla_train(cfg, p, x, positions, **kw)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    pad = cache_len - x.shape[1]
    k_rope = k_rope[:, :, 0, :]
    if pad > 0:
        ckv = torch.nn.functional.pad(ckv, (0, 0, 0, pad))
        k_rope = torch.nn.functional.pad(k_rope, (0, 0, 0, pad))
    return out, (ckv, k_rope)


def mla_decode(cfg, p, x, pos: int, cache):
    """Absorbed decode (the deployment path of arXiv:2405.04434): scores
    and context are taken against the latent cache directly; W_UK folds
    into the query and W_UV into the output. Row ``pos`` of both caches
    is written in place."""
    B = x.shape[0]
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    r = cfg.kv_lora_rank
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)        # (B,1,H,dn/dr)
    ckv_new, k_rope_new = _mla_latent(cfg, p, x, positions)
    ckv_cache, k_rope_cache = cache                      # (B,S,r), (B,S,dr)
    ckv_cache[:, pos] = ckv_new[:, 0].to(ckv_cache.dtype)
    k_rope_cache[:, pos] = k_rope_new[:, 0, 0].to(k_rope_cache.dtype)

    wkv_b = p["wkv_b"].reshape(r, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]        # (r,H,dn),(r,H,dv)
    # absorb W_UK into q: (B,1,H,dn) x (r,H,dn) -> (B,H,r)
    q_lat = torch.einsum("bqhd,rhd->bhr", q_nope, w_uk)
    s = torch.einsum("bhr,bkr->bhk", q_lat, ckv_cache).float()
    s = s + torch.einsum("bqhd,bkd->bhk", q_rope, k_rope_cache).float()
    s = s * (dn + dr) ** -0.5
    S = ckv_cache.shape[1]
    # a Python int stays on the host: no copy, so no stream sync
    mask = torch.arange(S, device=x.device) < pos + 1
    s = torch.where(mask, s, _NEG_INF)
    pweights = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhk,bkr->bhr", pweights.to(x.dtype), ckv_cache)
    o = torch.einsum("bhr,rhd->bhd", ctx_lat, w_uv)
    return o.reshape(B, 1, H * dv) @ p["wo"], (ckv_cache, k_rope_cache)
