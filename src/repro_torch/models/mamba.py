"""Mamba (S6 selective SSM) block of the Jamba hybrid
(``repro/models/mamba.py`` in PyTorch).

Recurrence (per channel c, state n):
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) * x_t
    y_t = C_t . h_t + D * x_t
with input-dependent dt (softplus), B, C. Training and prefill run the
reference's chunked scan: a loop over chunks carries the (B, d_inner,
d_state) boundary state, and within a chunk ``associative_scan`` runs the
same odd / even recursion as ``jax.lax.associative_scan``, so the products
of decays are formed in the reference's order (no division by a cumulative
product, which underflows). The chunk body is checkpointed whenever
autograd records through the input, so the backward pass recomputes the
(B, c, d_inner, d_state) expansions instead of keeping them, as the
reference's ``jax.checkpoint``.

Decode is one state update a token.

Leaves read in float32 (``transformer._keeps_float32``): ``a_log``
everywhere; ``conv_w``, ``conv_bias`` and ``d_skip`` in decode, while the
sequence pass casts them to the compute dtype at each use, as the
reference does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng

from .common import chunk_len, dense_init, split_keys

# the dt bias's range, float32 logs of 1e-3 and 0.1 (the reference's
# jnp.log of weak Python floats)
_DT_LO = np.log(np.float32(1e-3))
_DT_SPAN = float(np.log(np.float32(0.1)) - _DT_LO)


def init_mamba(key, cfg) -> dict:
    D, di = cfg.d_model, cfg.d_inner
    ds, dc, dtr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.dt_rank
    ks = split_keys(key, 6)
    dev = key.device
    # S4D-real initialization for A; dt bias init for softplus range.
    a_init = torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).repeat(di, 1)
    dt = torch.exp(prng.uniform(ks[4], (di,)) * _DT_SPAN + float(_DT_LO))
    return {
        "in_proj": dense_init(ks[0], D, 2 * di),           # -> [x, z]
        "conv_w": 0.1 * prng.normal(ks[1], (di, dc)),
        "conv_bias": torch.zeros(di, device=dev),
        "x_proj": dense_init(ks[2], di, dtr + 2 * ds),     # -> [dt, B, C]
        "dt_proj": dense_init(ks[3], dtr, di),
        "dt_bias": torch.log(torch.expm1(dt.clamp_min(1e-4))),
        "a_log": torch.log(a_init),                        # (di, ds)
        "d_skip": torch.ones(di, device=dev),
        "out_proj": dense_init(ks[5], di, D,
                               scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _ssm_params(cfg, p, xc):
    """xc: (B, S, di) post-conv activations -> dt, Bmat, Cmat (float32)."""
    ds, dtr = cfg.mamba_d_state, cfg.dt_rank
    proj = xc @ p["x_proj"]
    dt, Bm, Cm = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"].to(xc.dtype))
    return dt.float(), Bm.float(), Cm.float()


def _interleave(a, b, axis: int):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (len(a) is len(b) or
    one more)."""
    nb = b.shape[axis]
    out = torch.stack((a.narrow(axis, 0, nb), b), dim=axis + 1
                      ).flatten(axis, axis + 1)
    if a.shape[axis] > nb:
        out = torch.cat([out, a.narrow(axis, nb, 1)], dim=axis)
    return out


def _strided(t, start: int, stop: int | None, axis: int, step: int = 1):
    idx = [slice(None)] * t.dim()
    idx[axis] = slice(start, stop, step)
    return t[tuple(idx)]


def associative_scan(combine, elems: tuple, axis: int) -> tuple:
    """Inclusive scan of ``combine`` over ``axis``: the recursion of
    ``jax.lax.associative_scan`` (adjacent pairs combined, the half-length
    scan by recursion, the even elements from its results), so every
    element is combined in the same order."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = combine(tuple(_strided(e, 0, -1, axis, 2) for e in elems),
                      tuple(_strided(e, 1, None, axis, 2) for e in elems))
    odd = associative_scan(combine, reduced, axis)
    if n % 2 == 0:
        even = combine(tuple(_strided(e, 0, -1, axis) for e in odd),
                       tuple(_strided(e, 2, None, axis, 2) for e in elems))
    else:
        even = combine(odd, tuple(_strided(e, 2, None, axis, 2)
                                  for e in elems))
    even = tuple(torch.cat([_strided(e, 0, 1, axis), r], dim=axis)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _affine(a, b):
    # composition of affine maps h -> A h + b
    return a[0] * b[0], b[0] * a[1] + b[1]


def _scan_chunk(A, dt, Bm, Cm, xc, h0):
    """Associative scan within one chunk.

    A: (di, ds); dt: (B, C, di); Bm/Cm: (B, C, ds); xc: (B, C, di);
    h0: (B, di, ds). Returns (y (B, C, di) f32, h_last)."""
    dA = torch.exp(dt[..., None] * (-A))                   # (B,C,di,ds)
    dBx = (dt * xc)[..., None] * Bm[:, :, None, :]         # (B,C,di,ds)
    Acum, bcum = associative_scan(_affine, (dA, dBx), axis=1)
    h = Acum * h0[:, None] + bcum                          # (B,C,di,ds)
    y = torch.einsum("bcds,bcs->bcd", h, Cm)
    return y, h[:, -1]


def _conv(cfg, p, xs):
    """The causal depthwise conv along S in xs's dtype, then silu."""
    S, dc = xs.shape[1], cfg.mamba_d_conv
    xpad = F.pad(xs, (0, 0, dc - 1, 0))
    w = p["conv_w"].to(xs.dtype)
    xc = sum(xpad[:, i:i + S, :] * w[:, i] for i in range(dc))
    return F.silu(xc + p["conv_bias"].to(xs.dtype))


def mamba_seq(cfg, p, x, *, chunk: int = 256, remat: bool = True):
    """Full-sequence pass. x: (B, S, D) -> (B, S, D); ``p`` holds the
    projections in x's dtype."""
    B, S, _ = x.shape
    di = cfg.d_inner
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)       # (B,S,di) each
    xc = _conv(cfg, p, xs)
    A = torch.exp(p["a_log"].float())                      # (di, ds)
    c = chunk_len(S, chunk)

    def body(h0, xcc):
        # dt / B / C and the (B, c, di, ds) expansions are made inside the
        # checkpointed body: recomputed in backward, never kept
        dtc, Bc, Cc = _ssm_params(cfg, p, xcc)
        y, h1 = _scan_chunk(A, dtc, Bc, Cc, xcc.float(), h0)
        return h1, y.to(x.dtype)

    remat = remat and torch.is_grad_enabled() and x.requires_grad
    h = torch.zeros(B, di, cfg.mamba_d_state, device=x.device)
    ys = []
    for i in range(S // c):
        xcc = xc[:, i * c:(i + 1) * c]
        h, y = (checkpoint(body, h, xcc, use_reentrant=False) if remat
                else body(h, xcc))
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + xc * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"]


def mamba_init_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    return {
        "h": torch.zeros(batch, cfg.d_inner, cfg.mamba_d_state,
                         device=device),
        "conv": torch.zeros(batch, cfg.mamba_d_conv - 1, cfg.d_inner,
                            dtype=dtype, device=device),
    }


def mamba_decode(cfg, p, x, state):
    """One-token step. x: (B, 1, D); state: {'h', 'conv'}. Returns (out,
    the new state)."""
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)       # (B,1,di)
    window = torch.cat([state["conv"], xs], dim=1)         # (B,dc,di)
    xc = torch.einsum("bcd,dc->bd", window.float(), p["conv_w"].float())
    xc = F.silu(xc + p["conv_bias"].float())[:, None, :].to(x.dtype)

    dt, Bm, Cm = _ssm_params(cfg, p, xc)                   # (B,1,*)
    A = torch.exp(p["a_log"].float())
    dA = torch.exp(dt[:, 0, :, None] * (-A))               # (B,di,ds)
    dBx = (dt[:, 0, :] * xc[:, 0, :].float())[..., None] * Bm[:, 0, None, :]
    h = dA * state["h"] + dBx                              # (B,di,ds)
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0, :])
    y = y + xc[:, 0, :].float() * p["d_skip"].float()
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"h": h, "conv": window[:, 1:, :]}


def mamba_prefill(cfg, p, hn, chunk: int):
    """The sequence pass and the state after it (``transformer.py``'s
    ``_mamba_prefill``): the state is folded by a sequential scan in
    chunks of min(256, S), whatever ``chunk`` is, as in the reference."""
    B, S, _ = hn.shape
    out = mamba_seq(cfg, p, hn, chunk=chunk, remat=False)
    dc = cfg.mamba_d_conv
    xs, _ = torch.chunk(hn @ p["in_proj"], 2, dim=-1)
    xc = _conv(cfg, p, xs)
    dt, Bm, _ = _ssm_params(cfg, p, xc)
    A = torch.exp(p["a_log"].float())
    xf = xc.float()
    c = chunk_len(S, 256)
    h = torch.zeros(B, cfg.d_inner, cfg.mamba_d_state, device=hn.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        dA = torch.exp(dt[:, sl, :, None] * (-A))
        dBx = (dt[:, sl] * xf[:, sl])[..., None] * Bm[:, sl, None, :]
        for t in range(c):
            h = dA[:, t] * h + dBx[:, t]
    return out, {"h": h, "conv": xs[:, S - (dc - 1):, :]}
