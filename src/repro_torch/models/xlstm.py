"""xLSTM blocks (arXiv:2405.04517; ``repro/models/xlstm.py`` in
PyTorch): mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory,
a true recurrence).

mLSTM per head: C_t = f_t C_{t-1} + i_t v_t k_t^T ; n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t^T q_t|, exp(-m_t) + eps)
with an exponential input gate and a sigmoid forget gate in the log
domain, stabilised by the running max m_t. Training and prefill use the
chunkwise form of the reference: within a chunk a decay-masked attention,
across chunks the (C, n, m) state carried by a loop; chunk bodies are
checkpointed whenever autograd records through the input. The head width is
d_inner / n_heads, not ``head_dim``.

sLSTM is sequential by construction (the gates depend on h_{t-1} through
block-diagonal per-head recurrent weights): a Python loop over time, one
cell a step. Decode for both is one state update a token.

Leaves read in float32 (``transformer._keeps_float32``): mLSTM's ``b_if``,
sLSTM's ``r_gates`` and ``b_gates``; ``out_norm`` is cast to the compute
dtype at its use, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng

from .common import chunk_len, dense_init, split_keys

_EPS = 1e-6


# ------------------------------------------------------------------- mLSTM
def init_mlstm(key, cfg) -> dict:
    D, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    ks = split_keys(key, 7)
    dev = key.device
    return {
        "in_proj": dense_init(ks[0], D, 2 * di),            # -> [x, z]
        "wq": dense_init(ks[1], di, di),
        "wk": dense_init(ks[2], di, di),
        "wv": dense_init(ks[3], di, di),
        "w_if": dense_init(ks[4], di, 2 * H, scale=0.1),    # i, f gates
        "b_if": torch.cat([torch.zeros(H, device=dev),
                           torch.full((H,), 3.0, device=dev)]),
        "out_norm": torch.ones(di, device=dev),
        "out_proj": dense_init(ks[5], di, D,
                               scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _mlstm_heads(cfg, p, x):
    """x: (B, S, D) -> q, k, v (B, S, H, dh), log-gates i, f (B, S, H)
    float32, z (B, S, di)."""
    B, S, _ = x.shape
    H, di = cfg.n_heads, cfg.d_inner
    dh = di // H
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    q = (xi @ p["wq"]).reshape(B, S, H, dh)
    k = (xi @ p["wk"]).reshape(B, S, H, dh) * dh ** -0.5
    v = (xi @ p["wv"]).reshape(B, S, H, dh)
    gates = (xi @ p["w_if"]).float() + p["b_if"].float()
    ig, fg = torch.chunk(gates, 2, dim=-1)                  # (B,S,H) each
    return q, k, v, ig, F.logsigmoid(fg), z


def _mlstm_chunk(C0, n0, m0, qc, kc, vc, ic, lfc):
    """One chunk: its outputs (B, c, H, dh) and the state at its end."""
    c = qc.shape[1]
    F_ = torch.cumsum(lfc, dim=1)                       # (B,c,H) log decay
    # log weight of the past state at step t: m0 + F_t; of entry j <= t:
    # F_t - F_j + i_j
    a = F_ + m0[:, None, :]
    bmat = F_[:, :, None, :] - F_[:, None, :, :] + ic[:, None, :, :]
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool,
                                   device=qc.device))
    bmat = torch.where(causal[None, :, :, None], bmat, float("-inf"))
    m_new = torch.maximum(a, bmat.amax(dim=2))          # (B,c,H)
    w_past = torch.exp(a - m_new)
    w_in = torch.exp(bmat - m_new[:, :, None, :])       # (B,t,j,H)
    # intra-chunk attention-style term
    scores = torch.einsum("bthd,bjhd->btjh", qc, kc) * w_in
    num_in = torch.einsum("btjh,bjhd->bthd", scores, vc)
    den_in = scores.sum(dim=2)[..., None]               # (B,t,H,1)
    # cross-chunk term from the carried state
    num_past = torch.einsum("bthd,bhde->bthe", qc, C0) * w_past[..., None]
    den_past = torch.einsum("bthd,bhd->bth", qc, n0)[..., None] \
        * w_past[..., None]
    num = num_in + num_past
    den = den_in + den_past
    h = num / torch.maximum(den.abs(), torch.exp(-m_new)[..., None] + _EPS)
    C1, n1, m1 = _fold(C0, n0, m0, kc, vc, ic, F_)
    return C1, n1, m1, h


def _fold(C0, n0, m0, kc, vc, ic, F_):
    """The state after a chunk (F_ its cumulative log decay)."""
    Fc = F_[:, -1, :]                                   # (B,H) total decay
    m1 = torch.maximum(Fc + m0, (ic + (Fc[:, None, :] - F_)).amax(dim=1))
    sc = torch.exp(Fc + m0 - m1)                        # state scale
    wj = torch.exp(ic + Fc[:, None, :] - F_ - m1[:, None, :])  # (B,c,H)
    C1 = C0 * sc[..., None, None] + torch.einsum("bjh,bjhd,bjhe->bhde",
                                                 wj, kc, vc)
    n1 = n0 * sc[..., None] + torch.einsum("bjh,bjhd->bhd", wj, kc)
    return C1, n1, m1


def mlstm_seq(cfg, p, x, *, chunk: int = 256, remat: bool = True):
    """Chunkwise-parallel mLSTM. x: (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    di = cfg.d_inner
    q, k, v, ig, logf, z = _mlstm_heads(cfg, p, x)
    qf, kf, vf = q.float(), k.float(), v.float()
    c = chunk_len(S, chunk)
    st = mlstm_init_state(cfg, B, x.device)
    C, n, m = st["C"], st["n"], st["m"]
    remat = remat and torch.is_grad_enabled() and x.requires_grad
    hs = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        args = (C, n, m, qf[:, sl], kf[:, sl], vf[:, sl], ig[:, sl],
                logf[:, sl])
        C, n, m, h = (checkpoint(_mlstm_chunk, *args, use_reentrant=False)
                      if remat else _mlstm_chunk(*args))
        hs.append(h)
    h = (hs[0] if len(hs) == 1 else torch.cat(hs, dim=1))
    h = h.reshape(B, S, di).to(x.dtype)
    h = h * p["out_norm"].to(x.dtype)
    h = h * F.silu(z)
    return h @ p["out_proj"]


def mlstm_init_state(cfg, batch: int, device=None) -> dict:
    H, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    return {
        "C": torch.zeros(batch, H, dh, dh, device=device),
        "n": torch.zeros(batch, H, dh, device=device),
        "m": torch.full((batch, H), -1e30, device=device),
    }


def mlstm_decode(cfg, p, x, state):
    """x: (B, 1, D) -> (out, the new state)."""
    B = x.shape[0]
    q, k, v, ig, logf, z = _mlstm_heads(cfg, p, x)
    qt, kt, vt = (t[:, 0].float() for t in (q, k, v))
    it, lft = ig[:, 0], logf[:, 0]                          # (B,H)
    m1 = torch.maximum(lft + state["m"], it)
    fs = torch.exp(lft + state["m"] - m1)
    is_ = torch.exp(it - m1)
    C1 = state["C"] * fs[..., None, None] \
        + is_[..., None, None] * torch.einsum("bhd,bhe->bhde", kt, vt)
    n1 = state["n"] * fs[..., None] + is_[..., None] * kt
    num = torch.einsum("bhd,bhde->bhe", qt, C1)
    den = torch.einsum("bhd,bhd->bh", qt, n1)[..., None]
    h = num / torch.maximum(den.abs(), torch.exp(-m1)[..., None] + _EPS)
    h = h.reshape(B, 1, cfg.d_inner).to(x.dtype) * p["out_norm"].to(x.dtype)
    h = h * F.silu(z)
    return h @ p["out_proj"], {"C": C1, "n": n1, "m": m1}


def mlstm_prefill(cfg, p, hn, chunk: int):
    """The sequence pass and the state after it (``transformer.py``'s
    ``_mlstm_prefill``): the state is folded in chunks of min(256, S),
    whatever ``chunk`` is, as in the reference."""
    out = mlstm_seq(cfg, p, hn, chunk=chunk, remat=False)
    B, S, _ = hn.shape
    _, k, v, ig, logf, _ = _mlstm_heads(cfg, p, hn)
    kf, vf = k.float(), v.float()
    st = mlstm_init_state(cfg, B, hn.device)
    C, n, m = st["C"], st["n"], st["m"]
    c = chunk_len(S, 256)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        C, n, m = _fold(C, n, m, kf[:, sl], vf[:, sl], ig[:, sl],
                        torch.cumsum(logf[:, sl], dim=1))
    return out, {"C": C, "n": n, "m": m}


# ------------------------------------------------------------------- sLSTM
def init_slstm(key, cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    ks = split_keys(key, 3)
    dev = key.device
    return {
        "w_gates": dense_init(ks[0], D, 4 * D),             # z, i, f, o
        "r_gates": 0.1 * prng.normal(ks[1], (H, dh, 4 * dh)),
        "b_gates": torch.cat([torch.zeros(2 * D, device=dev),
                              torch.full((D,), 3.0, device=dev),
                              torch.zeros(D, device=dev)]),
        "out_proj": dense_init(ks[2], D, D,
                               scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def slstm_init_state(cfg, batch: int, device=None) -> dict:
    D = cfg.d_model
    return {
        "c": torch.zeros(batch, D, device=device),
        "n": torch.ones(batch, D, device=device),
        "h": torch.zeros(batch, D, device=device),
        "m": torch.zeros(batch, D, device=device),
    }


def _slstm_cell(cfg, p, xt, st) -> dict:
    """xt: (B, D) float32 pre-activations W x_t; st: the state."""
    B = xt.shape[0]
    D, H = cfg.d_model, cfg.n_heads
    hprev = st["h"].reshape(B, H, D // H)
    rec = torch.einsum("bhd,hde->bhe", hprev,
                       p["r_gates"].float()).reshape(B, 4 * D)
    pre = xt + rec + p["b_gates"].float()
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = F.logsigmoid(f)
    m1 = torch.maximum(logf + st["m"], i)
    fs = torch.exp(logf + st["m"] - m1)
    is_ = torch.exp(i - m1)
    c1 = fs * st["c"] + is_ * z
    n1 = fs * st["n"] + is_
    h1 = o * c1 / n1.clamp_min(_EPS)
    return {"c": c1, "n": n1, "h": h1, "m": m1}


def _slstm_run(cfg, p, x):
    """The cell over x's sequence: (hs (B, S, D) float32, the last
    state)."""
    B, S, _ = x.shape
    xg = (x @ p["w_gates"]).float()
    st = slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(cfg, p, xg[:, t], st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1), st


def slstm_seq(cfg, p, x):
    """x: (B, S, D) -> (B, S, D); the plain recurrence over time."""
    hs, _ = _slstm_run(cfg, p, x)
    return hs.to(x.dtype) @ p["out_proj"]


def slstm_prefill(cfg, p, hn):
    """The sequence pass and the state after it (``transformer.py``'s
    ``_slstm_prefill``)."""
    hs, st = _slstm_run(cfg, p, hn)
    return hs.to(hn.dtype) @ p["out_proj"], st


def slstm_decode(cfg, p, x, state):
    xg = (x[:, 0, :] @ p["w_gates"]).float()
    st1 = _slstm_cell(cfg, p, xg, state)
    return st1["h"][:, None, :].to(x.dtype) @ p["out_proj"], st1
