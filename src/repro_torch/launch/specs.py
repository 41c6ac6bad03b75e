"""Shape stand-ins and sharding specs for every (architecture x input
shape) cell (``repro/launch/specs.py`` in PyTorch).

Each builder returns (struct tree, spec tree): ``Struct(shape, dtype)``
leaves in the reference's tree, and spec tuples in the positions of its
``PartitionSpec`` (``sharding/rules.py``). Nothing is allocated: shapes
come from the meta device. ``launch/dryrun.py`` runs a rank of each cell
over them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.sharding import ShardingCtx, param_specs


class Struct(NamedTuple):
    """A leaf's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ------------------------------------------------------------------ batches
def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardingCtx,
                *, with_labels: bool):
    """(struct tree, spec tree) of one step's host batch."""
    B, S = shape.global_batch, shape.seq_len
    dp = ctx.dp_axes
    specs: dict[str, Any] = {}
    shards: dict[str, Any] = {}
    if cfg.family == "vlm":
        specs["embeds"] = Struct((B, S, cfg.d_model), _dtype(cfg.dtype))
        shards["embeds"] = ctx.spec((B, S, cfg.d_model), dp, None, None)
        specs["positions"] = Struct((3, B, S), torch.int32)
        shards["positions"] = ctx.spec((3, B, S), None, dp, None)
    else:
        specs["tokens"] = Struct((B, S), torch.int32)
        shards["tokens"] = ctx.spec((B, S), dp, None)
    if cfg.enc_dec:
        specs["frames"] = Struct((B, cfg.enc_seq, cfg.d_model),
                                 _dtype(cfg.dtype))
        shards["frames"] = ctx.spec((B, cfg.enc_seq, cfg.d_model),
                                    dp, None, None)
    if with_labels:
        specs["labels"] = Struct((B, S), torch.int32)
        shards["labels"] = ctx.spec((B, S), dp, None)
    return specs, shards


# ------------------------------------------------------------------- caches
def _structs(tree):
    if isinstance(tree, dict):
        return {k: _structs(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_structs(v) for v in tree)
    return Struct(tuple(tree.shape), tree.dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, Struct):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardingCtx):
    """(struct tree, spec tree) of the decode caches: batch over DP,
    cache sequence over 'model' (over (data, model) when the batch does
    not divide DP: context parallelism), recurrent-state inner dims over
    'model' where they divide; the stacked-periods dim never."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    B, S = shape.global_batch, shape.seq_len
    dtype = _dtype(cfg.dtype)
    if cfg.enc_dec:
        tree = encdec.init_dec_cache(cfg, B, S, dtype, "meta")
    else:
        tree = tfm.init_cache(cfg, B, S, dtype, "meta")
    specs = _structs(tree)
    dp, tp = ctx.dp_axes, ctx.tp_axis
    long_ctx = B % ctx.axis_size(dp) != 0

    def leaf_spec(x: Struct):
        wanted = []
        used_dp = used_tp = False
        for i, d in enumerate(x.shape):
            if i == 0:                      # stacked periods
                wanted.append(None)
            elif d == S and long_ctx:
                both = (ctx.fsdp_axis, tp)
                wanted.append(both if d % ctx.axis_size(both) == 0 else tp)
                used_tp = True
            elif d == S and not used_tp and d % ctx.axis_size(tp) == 0:
                wanted.append(tp)
                used_tp = True
            elif not used_dp and d == B and d % ctx.axis_size(dp) == 0:
                wanted.append(dp)
                used_dp = True
            elif (not used_tp and d != S and d >= 64
                    and d % ctx.axis_size(tp) == 0):
                wanted.append(tp)       # recurrent-state inner dim
                used_tp = True
            else:
                wanted.append(None)
        return ctx.spec(x.shape, *wanted)

    return specs, _map(leaf_spec, specs)


# ------------------------------------------------------------------- params
def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def param_struct_specs(cfg: ModelConfig, ctx: ShardingCtx, *, dtype=None):
    """(parameter struct tree, spec tree). ``dtype`` overrides the
    storage dtype (serve cells hold bfloat16 parameters)."""
    from repro_torch.models.model import param_shapes
    dt = torch.float32 if dtype is None else _dtype(dtype)
    shapes = _nest({k: Struct(s, dt) for k, s in param_shapes(cfg).items()})
    return shapes, param_specs(ctx, shapes)


def opt_state_specs(pstructs, pspecs):
    """The optimizer state mirrors the parameters (ZeRO sharding)."""
    return ({"m": pstructs, "v": pstructs,
             "step": Struct((), torch.int32)},
            {"m": pspecs, "v": pspecs, "step": ()})


def make_ctx(mesh, shape: ShapeConfig | None = None) -> ShardingCtx:
    """The context of a production or host mesh. ``shape`` is the
    reference's argument, which it does not read either."""
    multi = "pod" in mesh.mesh_dim_names
    dp = ("pod", "data") if multi else ("data",)
    return ShardingCtx(mesh=mesh, dp_axes=dp, tp_axis="model",
                       fsdp_axis="data")
