"""Divisibility-aware sharding rules (``repro/sharding/rules.py`` in
PyTorch).

Mesh contract (``launch/mesh.py``): axes ('data', 'model') on one pod or
('pod', 'data', 'model') across pods. Layout, as the reference's:

  * batch over DP = ('pod', 'data'); TP over 'model'; FSDP (ZeRO-3
    parameter and optimizer sharding) over 'data';
  * matmul weights (in, out): (fsdp, tp);
  * MoE expert stacks (E, in, out): (tp, fsdp, None), expert parallelism
    over 'model' (the island in ``models/mlp.py`` consumes it);
  * embeddings (V, D): vocab over tp when it divides, else (None, tp);
  * a decode cache whose batch does not divide DP spreads its sequence
    over (data, model) (context parallelism).

Every rule filters axes by divisibility, as the reference must (JAX
rejects a sharding that does not divide). A spec is a tuple with one
entry a dim, in the positions of the reference's ``PartitionSpec``: None,
an axis name, or a tuple of axis names. Specs are computed from the
mesh's axis names and sizes alone (a ``DeviceMesh``, or an
``AbstractMesh`` that holds no ranks), so the rules run anywhere. What
the layout means on the ranks (this rank's blocks, the gathers at use)
is ``sharding/layout.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.distributed import CollectiveTally, mesh_sizes


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks (the reference's
    ``jax.sharding.AbstractMesh``): what the spec rules read. The port
    also runs on it, on the meta device, as the mesh's first rank: its
    collectives run nothing and are counted in ``tally``
    (``core.distributed.axes_of``; the dry run)."""
    shape_tuple: tuple[int, ...]
    axis_names: tuple[str, ...]
    tally: CollectiveTally = dataclasses.field(
        default_factory=CollectiveTally, compare=False, repr=False)

    device_type = "meta"

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return self.axis_names

    def get_coordinate(self) -> list[int]:
        """The coordinates of the rank the mesh stands for: the first."""
        return [0] * len(self.axis_names)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Mesh + axis roles, threaded through the model builders.

    ``mesh=None`` (one device) makes every spec fully replicated and
    every layout point the identity."""
    mesh: object = None
    dp_axes: tuple[str, ...] = ("data",)       # ('pod','data') multi-pod
    tp_axis: str | None = "model"
    fsdp_axis: str | None = "data"             # param/optimizer sharding

    # -------------------------------------------------------------- sizes
    def axis_size(self, axes) -> int:
        if self.mesh is None or axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = mesh_sizes(self.mesh)
        return int(np.prod([sizes[a] for a in axes], dtype=np.int64))

    def _fit(self, dim: int, axes):
        """``axes`` if they evenly divide ``dim``, else None."""
        if axes is None or self.mesh is None:
            return None
        if dim % self.axis_size(axes) == 0:
            return axes
        return None

    def spec(self, shape: Sequence[int], *wanted) -> tuple:
        """The spec with non-dividing entries dropped."""
        if len(wanted) != len(shape):
            raise ValueError(f"spec of {tuple(shape)} wants {len(shape)} "
                             f"entries, got {wanted}")
        return tuple(self._fit(d, a) for d, a in zip(shape, wanted))

    def constrain(self, x, *wanted):
        """The layout point: ``x`` (whole on every rank) cut to this
        rank's block of ``spec(x.shape, *wanted)``; ``x`` itself off the
        mesh. It needs a ``DeviceMesh`` (ranks)."""
        if self.mesh is None:
            return x
        from .layout import block
        return block(self.mesh, x, self.spec(x.shape, *wanted))

    def shard_batch(self, x):
        """This rank's rows of an activation or input that every rank
        holds whole: batch over DP and, for (B, S, D), the sequence over
        'model' (Megatron sequence parallelism). Dims that do not divide
        (decode's S = 1) stay whole."""
        if self.mesh is None:
            return x
        if x.dim() == 3:
            return self.constrain(x, self.dp_axes, self.tp_axis, None)
        return self.constrain(x, self.dp_axes, *(None,) * (x.dim() - 1))


def param_spec(ctx: ShardingCtx, path: str, shape: Sequence[int]) -> tuple:
    """Sharding rule for one parameter, dispatched on its tree path.

    Paths are '/'-joined dict keys ('layers/pos0/attn/wq', 'embed/table').
    Leaves under a stacked layer axis ('layers', 'blocks') carry a leading
    layer dim, which is never sharded; the rules key on the trailing dims.
    Unknown leaves are replicated."""
    shape = tuple(shape)
    tp, fsdp = ctx.tp_axis, ctx.fsdp_axis
    name = path.split("/")[-1]
    stacked = "layers" in path or "blocks" in path
    lead = (None,) * (1 if stacked else 0)

    if ctx.mesh is None:
        return (None,) * len(shape)

    def tail_spec(*axes):
        if len(lead) + len(axes) != len(shape):
            raise ValueError(f"{path}: {shape} against {axes}")
        return ctx.spec(shape, *lead, *axes)

    # embeddings / unembedding (never stacked)
    if name in ("table", "unembed"):
        V = shape[0]
        if V % ctx.axis_size(tp) == 0:
            return ctx.spec(shape, tp, fsdp)
        return ctx.spec(shape, None, tp)
    if name == "pos_table":
        return ctx.spec(shape, None, tp)

    nd = len(shape) - len(lead)  # rank of the per-layer parameter

    # MoE expert stacks (E, in, out): EP over tp + FSDP over the in dim
    if nd == 3 and ("moe" in path or "experts" in path):
        return tail_spec(tp, fsdp, None)

    # biases / norms / gates (1-D): tp-sized inner vectors of the SSM
    if nd == 1:
        return tail_spec(tp if name in ("d_skip", "conv_bias", "dt_bias")
                         else None)

    # row-parallel output projections: the contracted dim carries tp
    if nd == 2 and name in ("wo", "w_down", "out_proj", "down"):
        return tail_spec(tp, fsdp)

    # SSM block internals: the inner (d_inner) dim carries tp
    if nd == 2 and name in ("x_proj", "w_if"):
        return tail_spec(tp, None)
    if nd == 2 and name == "a_log":
        return tail_spec(tp, None)

    # conv kernels (channels, width): channels over tp
    if nd == 2 and name.startswith("conv"):
        return tail_spec(tp, None)

    # default matmul weight (in, out): column parallel + FSDP
    if nd == 2:
        return tail_spec(fsdp, tp)
    return (None,) * len(shape)


def param_specs(ctx: ShardingCtx, params) -> dict:
    """A spec tree mirroring a parameter tree (nested dicts of tensors, or
    of anything with a ``shape``)."""
    def visit(prefix, node):
        if isinstance(node, dict):
            return {k: visit(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        return param_spec(ctx, prefix, tuple(node.shape))
    return visit("", params)
