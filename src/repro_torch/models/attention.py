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
three streams where ``cfg.mrope``.

On a mesh (``rows``: this rank's layout, ``sharding/layout.py``) the
reference's two islands are written out. ``seq_parallel_attention``: each
rank's queries are its own rows of the sequence (over 'model'), run
against K / V gathered over 'model', with ``q_offset`` fixing causality.
The port takes this form whether or not ``seq_parallel_attn`` is set: the
reference's GSPMD computes the same function without it. Prefill keeps
each rank's cache shard by cache position (``cache_shard``), not the rows
it computed. ``decode_attn_island``: the GQA cache is held batch over the
data-parallel axes and sequence over 'model' (over (data, model) when the
batch does not divide, the 2-D context-parallel form); each rank writes
the new row only when ``pos`` falls in its shard, and the partial
softmaxes combine with a max and two sums over the sequence's axes.
MLA's latent cache is held as the reference's ``mla_decode`` pins it,
batch over DP and sequence over 'model', and combined the same way.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import layout as lo

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


def seq_parallel_attention(rows, q, k, v, *, causal=True, q_chunk=1024,
                           kv_chunk=1024, skip_masked_blocks=False):
    """The sequence-parallel island. q, k, v: this rank's rows (B_l, S_l,
    ...); K / V are gathered over 'model' and the local queries run
    against them from offset ``rows.s0``. Plain blockwise attention off
    the mesh or when the sequence does not divide."""
    if rows is None or not rows.s_split:
        return blockwise_attn(q, k, v, causal=causal, q_chunk=q_chunk,
                              kv_chunk=kv_chunk,
                              skip_masked_blocks=skip_masked_blocks)
    k, v = _gather_kv(rows, k, v)
    return blockwise_attn(q, k, v, causal=causal, q_offset=rows.s0,
                          q_chunk=min(q_chunk, rows.S_l), kv_chunk=kv_chunk,
                          skip_masked_blocks=skip_masked_blocks)


def _gather_kv(rows, k, v):
    """K and V gathered over 'model' in one collective."""
    kv = rows.gather_seq(torch.cat([k, v], dim=-1))
    return kv[..., :k.shape[-1]], kv[..., k.shape[-1]:]


def cache_seq_axes(rows, cache_len: int, *, two_d: bool = True) -> tuple:
    """The axes a decode cache's sequence is split over: 'model' when the
    batch divides DP, else (data, model) (``two_d``; the GQA island's
    context-parallel form); none when that does not divide ``cache_len``
    or off the mesh."""
    if rows is None:
        return ()
    lay = rows.lay
    axes = lay.tp if rows.b_split or not two_d else lay.cp
    if not axes or cache_len % lay.size(axes):
        return ()
    return axes


def cache_shard(rows, x, cache_len: int, seq_axes) -> torch.Tensor:
    """This rank's shard of a prefill cache: ``x`` (B_l, S, ...) whole
    over the sequence, zero-padded to ``cache_len`` and cut to the
    positions ``seq_axes`` give this rank."""
    pad = cache_len - x.shape[1]
    if pad > 0:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    if seq_axes:
        n = cache_len // rows.lay.size(seq_axes)
        x = x.narrow(1, rows.lay.index(seq_axes) * n, n)
    return x


def _combine(lay, seq_axes, m_loc, l_loc, o_loc):
    """Partial softmaxes (max, sum, weighted values) over the sequence
    shards: one max, then the two sums in one collective."""
    axes = lay.axes(seq_axes)
    m = lo.pmax(m_loc, axes)
    corr = torch.exp(m_loc - m)
    lo_ = lo.psum(torch.cat([(l_loc * corr)[..., None],
                             o_loc * corr[..., None]], dim=-1), axes)
    return lo_[..., 1:] / lo_[..., :1].clamp_min(1e-30)


def _write_row(cache, new, pos: int, start: int) -> None:
    """Row ``pos`` of a cache shard starting at ``start``, if it is
    there."""
    rel = pos - start
    if 0 <= rel < cache.shape[1]:
        cache[:, rel] = new.to(cache.dtype)


def decode_attn_island(rows, seq_axes, q, k_cache, v_cache, pos: int,
                       k_new, v_new):
    """Cached decode over a cache whose sequence is split over
    ``seq_axes``. q / k_new / v_new: (B_l, 1, H | KVH, dh); caches:
    this rank's shard (B_l, S_loc, KVH, dh), written in place. Returns
    the attention output (B_l, 1, H, dh)."""
    if not seq_axes:
        k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
        return decode_attn(q, k_cache, v_cache, pos + 1)
    lay = rows.lay
    B, S_loc, KVH, _ = k_cache.shape
    H, dh = q.shape[2], q.shape[3]
    start = lay.index(seq_axes) * S_loc
    _write_row(k_cache, k_new[:, 0], pos, start)
    _write_row(v_cache, v_new[:, 0], pos, start)
    qr = q.reshape(B, KVH, H // KVH, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache).float() * dh ** -0.5
    valid = (start + torch.arange(S_loc, device=q.device)) <= pos
    s = torch.where(valid, s, _NEG_INF)
    m_loc = s.amax(dim=-1)
    p = torch.exp(s - m_loc[..., None])
    o_loc = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype),
                         v_cache).float()
    o = _combine(lay, seq_axes, m_loc, p.sum(dim=-1), o_loc)
    return o.to(q.dtype).reshape(B, 1, H, dh)


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
              skip_masked_blocks=False, rope=True, causal=True, rows=None):
    q, k, v = gqa_qkv(cfg, p, x, positions, rope=rope)
    o = seq_parallel_attention(rows, q, k, v, causal=causal,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               skip_masked_blocks=skip_masked_blocks)
    return gqa_out(cfg, p, o)


def gqa_prefill(cfg, p, x, positions, cache_len, *, q_chunk=1024,
                kv_chunk=1024, skip_masked_blocks=False, rope=True,
                rows=None):
    """Returns (out, (k_cache, v_cache)): caches zero-padded to
    cache_len (on a mesh: this rank's shard of them)."""
    q, k, v = gqa_qkv(cfg, p, x, positions, rope=rope)
    o = seq_parallel_attention(rows, q, k, v, q_chunk=q_chunk,
                               kv_chunk=kv_chunk,
                               skip_masked_blocks=skip_masked_blocks)
    if rows is not None and rows.s_split:
        k, v = _gather_kv(rows, k, v)
    axes = cache_seq_axes(rows, cache_len)
    return gqa_out(cfg, p, o), (cache_shard(rows, k, cache_len, axes),
                                cache_shard(rows, v, cache_len, axes))


def gqa_decode(cfg, p, x, pos: int, cache, *, rope: bool = True,
               rows=None, cache_len: int = 0):
    """One-token step. x: (B, 1, D); pos: the current index, which is
    also the token's position (on all three streams under M-RoPE, as in
    the reference); cache: (k, v) each (B, S_max, KVH, dh). Row ``pos``
    of the cache is written in place (the reference's
    dynamic_update_slice); returns (out, cache). On a mesh the cache is
    this rank's shard of a ``cache_len`` cache (``decode_attn_island``)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        positions = positions.expand(3, B, 1)
    q, k_new, v_new = gqa_qkv(cfg, p, x, positions, rope=rope)
    k_cache, v_cache = cache
    o = decode_attn_island(rows, cache_seq_axes(rows, cache_len), q,
                           k_cache, v_cache, pos, k_new, v_new)
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


def _mla_attend(cfg, p, x, positions, rows, *, q_chunk, kv_chunk,
                skip_masked_blocks):
    """(out, ckv, k_rope): the attention over the latent expanded to full
    per-head K / V (k_rope shared by the heads), and the latent whole
    over the sequence. On a mesh the latent, the narrowest thing, is
    what is gathered over 'model'; the local queries start at
    ``rows.s0``."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    off = 0
    if rows is not None and rows.s_split:
        r = ckv.shape[-1]
        lat = rows.gather_seq(torch.cat([ckv, k_rope[:, :, 0]], dim=-1))
        ckv, k_rope = lat[..., :r], lat[..., None, r:]
        off, q_chunk = rows.s0, min(q_chunk, rows.S_l)
    Skv = ckv.shape[1]
    kv = (ckv @ p["wkv_b"]).reshape(B, Skv, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(B, Skv, H, dr)], -1)
    o = blockwise_attn(q, k, v, q_offset=off, q_chunk=q_chunk,
                       kv_chunk=kv_chunk,
                       skip_masked_blocks=skip_masked_blocks)
    return o.reshape(B, S, H * dv) @ p["wo"], ckv, k_rope


def mla_train(cfg, p, x, positions, *, q_chunk=1024, kv_chunk=1024,
              skip_masked_blocks=False, rows=None):
    """Training / prefill: the latent expanded to full per-head K / V;
    k_rope is shared by the heads."""
    return _mla_attend(cfg, p, x, positions, rows, q_chunk=q_chunk,
                       kv_chunk=kv_chunk,
                       skip_masked_blocks=skip_masked_blocks)[0]


def mla_prefill(cfg, p, x, positions, cache_len, *, q_chunk=1024,
                kv_chunk=1024, skip_masked_blocks=False, rows=None):
    """Returns (out, (ckv_cache, k_rope_cache)): the *latent* cache,
    kv_lora_rank + qk_rope_dim values a token instead of H (dn + dv),
    zero-padded to cache_len (on a mesh: this rank's shard)."""
    out, ckv, k_rope = _mla_attend(cfg, p, x, positions, rows,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   skip_masked_blocks=skip_masked_blocks)
    axes = cache_seq_axes(rows, cache_len, two_d=False)
    return out, (cache_shard(rows, ckv, cache_len, axes),
                 cache_shard(rows, k_rope[:, :, 0, :], cache_len, axes))


def mla_decode(cfg, p, x, pos: int, cache, *, rows=None,
               cache_len: int = 0):
    """Absorbed decode (the deployment path of arXiv:2405.04434): scores
    and context are taken against the latent cache directly; W_UK folds
    into the query and W_UV into the output. Row ``pos`` of both caches
    is written in place. On a mesh the caches are this rank's shards
    (batch over DP, sequence over 'model') and the partial softmaxes
    combine over 'model'."""
    B = x.shape[0]
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    r = cfg.kv_lora_rank
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)        # (B,1,H,dn/dr)
    ckv_new, k_rope_new = _mla_latent(cfg, p, x, positions)
    ckv_cache, k_rope_cache = cache                      # (B,S,r), (B,S,dr)
    axes = cache_seq_axes(rows, cache_len, two_d=False)
    S = ckv_cache.shape[1]
    start = rows.lay.index(axes) * S if axes else 0
    _write_row(ckv_cache, ckv_new[:, 0], pos, start)
    _write_row(k_rope_cache, k_rope_new[:, 0, 0], pos, start)

    wkv_b = p["wkv_b"].reshape(r, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]        # (r,H,dn),(r,H,dv)
    # absorb W_UK into q: (B,1,H,dn) x (r,H,dn) -> (B,H,r)
    q_lat = torch.einsum("bqhd,rhd->bhr", q_nope, w_uk)
    s = torch.einsum("bhr,bkr->bhk", q_lat, ckv_cache).float()
    s = s + torch.einsum("bqhd,bkd->bhk", q_rope, k_rope_cache).float()
    s = s * (dn + dr) ** -0.5
    # a Python int stays on the host: no copy, so no stream sync
    mask = start + torch.arange(S, device=x.device) < pos + 1
    s = torch.where(mask, s, _NEG_INF)
    if axes:
        m_loc = s.amax(dim=-1)
        pw = torch.exp(s - m_loc[..., None])
        part = torch.einsum("bhk,bkr->bhr", pw.to(x.dtype), ckv_cache)
        ctx_lat = _combine(rows.lay, axes, m_loc, pw.sum(dim=-1),
                           part.float()).to(x.dtype)
    else:
        pweights = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhk,bkr->bhr", pweights.to(x.dtype),
                               ckv_cache)
    o = torch.einsum("bhr,rhd->bhd", ctx_lat, w_uv)
    return o.reshape(B, 1, H * dv) @ p["wo"], (ckv_cache, k_rope_cache)
