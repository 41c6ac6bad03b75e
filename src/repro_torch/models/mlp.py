"""Feed-forward blocks: SwiGLU and the top-k MoE (``repro/models/mlp.py``).

MoE on one device: the reference's local path (``e0 = 0``, ``E_loc =
E``). Each token's top-k assignments queue at their experts in flattened
(T * K) assignment order; an expert takes at most C = int(T K f) // E of
them (f the capacity factor) and the rest are dropped, GShard-style, as
in the reference. The kept assignments are gathered into an (E, C, D)
buffer, the three expert products run as batched matmuls, and the outputs
are scattered back weighted by the renormalised gates. The expert
products stay plain PyTorch, as the reference computes them in plain XLA.
The GELU MLP (the encoder-decoder's, with biases) uses the tanh
approximation, as ``jax.nn.gelu`` does by default (``torch``'s default is
the erf form).

On a mesh (``rows``, ``sharding/layout.py``) ``moe_apply`` runs the
reference's island where it applies (E divides 'model' and the batch
divides DP, ``mlp.py``'s condition): each model rank takes its E / tp
experts (e0 = model index x E_loc, the expert stacks' blocks over
'model'), routes all of its data shard's tokens (gathered over 'model'),
with the capacity computed from those T tokens, and the outputs sum over
'model'; each rank keeps its own rows. So a data shard drops what it
would drop alone: on a mesh the MoE is per-data-shard capacity, not the
one-device MoE spread over ranks. Otherwise the local path runs on the
whole batch (gathered over every split axis), as GSPMD runs the
reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.sharding import layout as lo

from .common import dense_init, split_keys


# ---------------------------------------------------------------- dense FFN
def init_swiglu(key, d_model: int, d_ff: int, n_layers: int) -> dict:
    ks = split_keys(key, 3)
    return {
        "w_gate": dense_init(ks[0], d_model, d_ff),
        "w_up": dense_init(ks[1], d_model, d_ff),
        "w_down": dense_init(ks[2], d_ff, d_model,
                             scale=1.0 / (2 * n_layers) ** 0.5),
    }


def swiglu(p: dict, x):
    """``p`` holds the weights in x's dtype."""
    g = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]


def init_gelu_mlp(key, d_model: int, d_ff: int, n_layers: int,
                  use_bias: bool = True) -> dict:
    ks = split_keys(key, 2)
    p = {
        "w_up": dense_init(ks[0], d_model, d_ff),
        "w_down": dense_init(ks[1], d_ff, d_model,
                             scale=1.0 / (2 * n_layers) ** 0.5),
    }
    if use_bias:
        dev = key.device
        p.update(b_up=torch.zeros(d_ff, device=dev),
                 b_down=torch.zeros(d_model, device=dev))
    return p


def gelu_mlp(p: dict, x):
    """``p`` holds the weights and biases in x's dtype."""
    h = x @ p["w_up"]
    if "b_up" in p:
        h = h + p["b_up"]
    out = F.gelu(h, approximate="tanh") @ p["w_down"]
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# --------------------------------------------------------------------- MoE
def init_moe(key, cfg) -> dict:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    ks = split_keys(key, 5)
    p = {
        "router": dense_init(ks[0], D, E, scale=0.1),
        "moe_gate": _stack_expert_init(ks[1], E, D, Fd),
        "moe_up": _stack_expert_init(ks[2], E, D, Fd),
        "moe_down": _stack_expert_init(ks[3], E, Fd, D,
                                       scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(ks[4], D, cfg.n_shared_experts * Fd,
                                  cfg.n_layers)
    return p


def _stack_expert_init(key, E, d_in, d_out, scale=1.0):
    """E ``dense_init`` draws, one from each of ``split(key, E)``, drawn
    as one batch (a batch of keys gives each key's own stream)."""
    std = scale / (d_in ** 0.5)
    return std * prng.truncated_normal(prng.split(key, E), -2.0, 2.0,
                                       (d_in, d_out))


def capacity(cfg, n_tokens: int, capacity_factor: float | None = None
             ) -> int:
    """Slots an expert has for ``n_tokens`` tokens."""
    f = cfg.moe_capacity_factor if capacity_factor is None \
        else capacity_factor
    return max(1, int(n_tokens * cfg.top_k * f) // cfg.n_experts)


def _route(x2d, router_w, top_k: int):
    """Top-k softmax routing in float32. x2d: (T, D). Returns gates (T, K)
    float32 and expert ids (T, K) int32."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, eidx.to(torch.int32)


def _slots(eidx, e0: int, E_loc: int, C: int):
    """Each (token, k) assignment's place: (keep, expert, position), all
    (T * K,). The position counts the assignments before it at the same
    expert in flattened (T * K) order; an assignment is kept iff its
    expert is in [e0, e0 + E_loc) and its position is below C. Expert and
    position are clipped into the buffer for the dropped ones."""
    e_rel = eidx.reshape(-1).long() - e0
    in_slice = (e_rel >= 0) & (e_rel < E_loc)
    # (E_loc, T*K) one-hot, expert-major: the running count goes along
    # the last dimension (a scan along the first, over T*K rows of E_loc
    # columns, is one of the card's slowest kernels)
    oh = (e_rel[None, :] == torch.arange(E_loc, device=e_rel.device)[:, None]
          ).long()
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(0)      # prior count
    keep = in_slice & (pos < C)
    return keep, e_rel.clamp(0, E_loc - 1), pos.clamp(0, C - 1)


def _expert_pass(xt, gates, eidx, wg, wu, wd, e0: int, E_loc: int, C: int):
    """Gather the tokens of experts [e0, e0 + E_loc), run the expert
    products, scatter back. xt: (T, D); wg / wu: (E_loc, D, F), wd:
    (E_loc, F, D), in xt's dtype.

    Every kept assignment has a buffer row of its own; the dropped ones
    all point at one spare row past the buffer, which holds zeros. So the
    gather is a copy whose only collisions write zeros, and its backward
    is a gather; the combine's backward adds each kept row's gradient
    once and only zeros to the spare row. Neither depends on the order of
    the writes."""
    T, D = xt.shape
    K = eidx.shape[1]
    keep, e_safe, p_safe = _slots(eidx, e0, E_loc, C)
    row = torch.where(keep, e_safe * C + p_safe, E_loc * C)
    xt_rep = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros(E_loc * C + 1, D, dtype=xt.dtype, device=xt.device)
    buf = buf.index_copy(0, row, torch.where(keep[:, None], xt_rep, 0.0))
    buf = buf[:-1].view(E_loc, C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, wu)
    y = torch.einsum("ecf,efd->ecd", h, wd)
    y = torch.cat([y.reshape(E_loc * C, D), y.new_zeros(1, D)])
    got = y.index_select(0, row)                              # (T*K, D)
    gate = torch.where(keep, gates.reshape(-1).to(xt.dtype), 0.0)
    return (got * gate[:, None]).reshape(T, K, D).sum(dim=1)


def _local(cfg, p, x, e0: int, E_loc: int, capacity_factor):
    """Route x's tokens, run experts [e0, e0 + E_loc), with the capacity
    of x's own T tokens."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gates, eidx = _route(xt, p["router"], cfg.top_k)
    C = capacity(cfg, T, capacity_factor)
    w = [p[k] if p[k].shape[0] == E_loc else p[k][e0:e0 + E_loc]
         for k in ("moe_gate", "moe_up", "moe_down")]
    return _expert_pass(xt, gates, eidx, *w, e0, E_loc, C).reshape(B, S, D)


# The expert stacks: on a mesh the block's gather leaves them to
# ``moe_apply``, which gathers them as its path needs.
EXPERT_STACKS = ("moe_gate", "moe_up", "moe_down")


def moe_island(rows, n_experts: int) -> bool:
    """The reference's island condition: E divides 'model' and the batch
    divides DP."""
    lay = rows.lay
    return bool(lay.tp) and rows.b_split and \
        n_experts % lay.size(lay.tp) == 0


def moe_apply(cfg, p: dict, x, *, capacity_factor: float | None = None,
              rows=None, path: str = "moe"):
    """x: (B, S, D) -> (B, S, D). ``p`` holds the expert weights in x's
    dtype and the router in float32. On a mesh x is this rank's rows and
    the expert stacks (``EXPERT_STACKS``) are whole or, when they arrive
    as blocks (``rows.gather_params``; ``path``: the tree path of ``p``),
    gathered here: under the island over every axis but 'model' (this
    rank's E / tp experts), else whole."""
    E = cfg.n_experts
    if rows is None:
        y = _local(cfg, p, x, 0, E, capacity_factor)
    elif moe_island(rows, E):
        lay = rows.lay
        p = dict(p, **{k: rows.param(p[k], f"{path}/{k}", keep=lay.tp)
                       for k in EXPERT_STACKS})
        E_loc = E // lay.size(lay.tp)
        part = _local(cfg, p, rows.gather_seq(x), lay.index(lay.tp) * E_loc,
                      E_loc, capacity_factor)
        y = rows.own_seq(lo.psum(part, lay.axes(lay.tp)))
    else:
        p = dict(p, **{k: rows.param(p[k], f"{path}/{k}")
                       for k in EXPERT_STACKS})
        y = rows.own_rows(_local(cfg, p, rows.gather_rows(x), 0, E,
                                 capacity_factor))
    if cfg.n_shared_experts:
        y = y + swiglu(p["shared"], x)
    return y
