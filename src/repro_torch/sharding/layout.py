"""How the port stands in for GSPMD: the mesh layout on the ranks.

The reference states a layout (``rules.py``) and GSPMD inserts the
collectives. Torch has none, so the port writes both out, one SPMD
process a rank (as ``core/distributed.py`` runs the SVM):

  * parameters, their gradients and AdamW's m / v are held as this rank's
    block of every leaf (``shard_tree``), the block ``param_spec`` gives
    it; a dim whose axis the spec drops stays whole (ZeRO-3);
  * at use a leaf is cast to the compute dtype first and gathered second
    over the axes its spec names (``gather_param``); a block's leaves go
    in one collective over the mesh (``gather_leaves``), since every
    collective through gloo is a round trip through the host. The gather
    sits under autograd: its backward sums the cotangent over the mesh
    and keeps this rank's block, so after the backward pass every rank
    holds the whole gradient of its block;
  * activations are this rank's rows (``Rows``): the batch over the
    data-parallel axes where it divides, and for (B, S, D) the sequence
    over 'model' where it divides (the reference's ``shard_batch``).
    ``Rows.gather_seq`` / ``gather_batch`` assemble them under autograd
    (backward: the sum of the cotangents over the same axes, this rank's
    block kept) and ``psum`` sums partials (backward: the same sum);
  * a whole leaf is cut to its block as it is made (``keep``: the
    initial draw one layer at a time, a restore one leaf at a time), so
    no rank holds a whole model; ``gather_host`` brings a sharded tree
    whole to the mesh's first rank, one leaf at a time, into host memory
    (snapshots); ``full_tree`` gathers it whole on every rank (tests).

gloo has no reduce-scatter: a sum that keeps one block is an
``all_reduce`` and a slice. Blocks over several axes are indexed
row-major in the order the spec names them, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as cdist

from .rules import ShardingCtx, mesh_sizes, param_spec


def _names(entry) -> tuple[str, ...]:
    """The axis names of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def coords(mesh) -> dict:
    """{axis name: this rank's index on it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def index(mesh, names: Sequence[str]) -> tuple[int, int]:
    """(this rank's row-major index over ``names``, their total size)."""
    c, sizes = coords(mesh), mesh_sizes(mesh)
    idx, n = 0, 1
    for a in names:
        idx = idx * sizes[a] + c[a]
        n *= sizes[a]
    return idx, n


def block(mesh, x, spec: Sequence):
    """This rank's block of ``x`` (whole on every rank; a tensor or a
    host array) under ``spec``: a view."""
    cut = []
    for d, entry in enumerate(spec):
        names = _names(entry)
        if names:
            i, n = index(mesh, names)
            m = x.shape[d] // n
            cut.append(slice(i * m, (i + 1) * m))
        else:
            cut.append(slice(None))
    return x[tuple(cut)]


# ---------------------------------------------------------- collectives
def _all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over ``axes`` (a ``MeshAxes``) side by side
    along ``dim``, in the axes' index order."""
    return x if axes.size == 1 else cdist.all_gather(x, axes, dim)


def _all_reduce(x: torch.Tensor, axes, op=dist.ReduceOp.SUM):
    if axes is None or axes.size == 1:
        return x
    return cdist.all_reduce(x, axes, op)


def _own(x: torch.Tensor, plan) -> torch.Tensor:
    for dim, axes in plan:
        m = x.shape[dim] // axes.size
        x = x.narrow(dim, axes.index * m, m)
    return x


class _Gather(torch.autograd.Function):
    """Gathers ``x`` along each (dim, axes) of ``plan``; the backward sums
    the cotangent over ``red`` and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, plan, red):
        ctx.plan, ctx.red = plan, red
        for dim, axes in plan:
            x = _all_gather(x, axes, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        return _own(_all_reduce(g, ctx.red), ctx.plan).contiguous(), \
            None, None


class _GatherLeaves(torch.autograd.Function):
    """Several leaves' blocks (one dtype) gathered whole in one collective
    over the whole mesh: every rank's blocks flattened into one buffer,
    gathered, and each leaf assembled from the blocks by its spec. The
    backward sums the whole gradients over the mesh in one collective and
    keeps this rank's blocks."""

    @staticmethod
    def forward(ctx, lay, specs, *blocks):
        ctx.lay, ctx.specs = lay, specs
        world = lay.axes(lay.all)
        flat = torch.cat([b.reshape(-1) for b in blocks])
        parts = _all_gather(flat, world, 0).view(world.size, -1)
        if parts.is_meta:          # shapes only: no blocks to assemble
            return tuple(b.new_empty(lay.full_shape(b.shape, spec))
                         for b, spec in zip(blocks, specs))
        outs = []
        off = 0
        for b, spec in zip(blocks, specs):
            full = b.new_empty(lay.full_shape(b.shape, spec))
            for r in range(world.size):
                slot = full
                for d, e in enumerate(spec):
                    names = _names(e)
                    if names:
                        n = b.shape[d]
                        slot = slot.narrow(d, lay.index_of(r, names) * n, n)
                slot.copy_(parts[r, off:off + b.numel()].view(b.shape))
            off += b.numel()
            outs.append(full)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        lay = ctx.lay
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                           lay.axes(lay.all))
        out, off = [], 0
        for g, spec in zip(grads, ctx.specs):
            full = flat[off:off + g.numel()].view(g.shape)
            off += g.numel()
            out.append(block(lay.mesh, full, spec).contiguous())
        return (None, None, *out)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes), None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (a ``MeshAxes``), under autograd."""
    if axes.size == 1:
        return x
    return _Psum.apply(x, axes)


def gather(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """``x``'s blocks over ``axes`` (a ``MeshAxes``) side by side along
    ``dim``, under autograd (backward: the sum over ``axes``, this rank's
    block kept)."""
    if axes.size == 1:
        return x
    return _Gather.apply(x, [(dim, axes)], axes)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max over ``axes`` (no gradient)."""
    return _all_reduce(x, axes, dist.ReduceOp.MAX)


# --------------------------------------------------------------- layout
class Layout:
    """The mesh as one model's ranks see it: the context, the parameter
    specs (by leaf path, as ``param_spec`` gives them for the full
    shapes) and the process groups of the axis sets the model reduces
    over, made once here on every rank in the same order."""

    def __init__(self, ctx: ShardingCtx, shapes: dict):
        cdist.check_mesh(ctx.mesh)
        self.ctx, self.mesh = ctx, ctx.mesh
        self.shapes = dict(shapes)
        self.specs = {k: param_spec(ctx, k, s) for k, s in shapes.items()}
        names = tuple(self.mesh.mesh_dim_names)
        self.all = names
        self.tp = (ctx.tp_axis,) if ctx.tp_axis else ()
        self.dp = tuple(ctx.dp_axes)
        self.cp = tuple(a for a in (ctx.fsdp_axis, ctx.tp_axis) if a)
        self.sizes = mesh_sizes(self.mesh)
        for axes in ([(a,) for a in names] + [self.dp, self.cp, names,
                                              self._without(self.tp)]):
            if axes:
                self.axes(axes)

    def _without(self, keep) -> tuple[str, ...]:
        return tuple(a for a in self.all if a not in keep)

    def axes(self, names):
        return cdist.axes_of(self.mesh, tuple(names))

    def size(self, names) -> int:
        return int(np.prod([self.sizes[a] for a in names], dtype=np.int64))

    def index(self, names) -> int:
        return index(self.mesh, names)[0]

    def index_of(self, r: int, names) -> int:
        """The row-major index over ``names`` of the rank at linear index
        ``r`` over all the mesh's axes."""
        c, rest = {}, r
        for a in reversed(self.all):
            c[a] = rest % self.sizes[a]
            rest //= self.sizes[a]
        idx = 0
        for a in names:
            idx = idx * self.sizes[a] + c[a]
        return idx

    def full_shape(self, shape, spec) -> tuple:
        """A leaf's whole shape from its block's."""
        return tuple(n * self.size(_names(e)) for n, e in zip(shape, spec))

    def gather_leaves(self, leaves: list, specs: list) -> list:
        """Leaves' blocks gathered whole under autograd, one collective for
        each dtype among them (``_GatherLeaves``)."""
        out = list(leaves)
        by_dtype: dict = {}
        for i, x in enumerate(leaves):
            by_dtype.setdefault(x.dtype, []).append(i)
        for idx in by_dtype.values():
            got = _GatherLeaves.apply(self, [specs[i] for i in idx],
                                      *[leaves[i] for i in idx])
            for i, g in zip(idx, got):
                out[i] = g
        return out

    # ------------------------------------------------------ parameters
    def keep(self, path: str, x, *, stacked: bool = False,
             device=None) -> torch.Tensor:
        """This rank's block of leaf ``path``, from the whole leaf ``x``
        (a tensor or a host array; one layer's slice of a stacked leaf
        when ``stacked``), as a tensor of its own storage on ``device``
        (``x``'s when None), so the whole can be freed. A host array is
        read only as far as the block reaches (a memory-mapped file)."""
        spec = self.specs[path]
        if stacked:
            if spec[0] is not None:
                raise ValueError(f"{path}: the layer dim is sharded ({spec})")
            spec = spec[1:]
        b = block(self.mesh, x, spec)
        if isinstance(b, torch.Tensor):
            return b.clone() if device is None else b.to(device, copy=True)
        return torch.from_numpy(np.array(b)).to(device)

    def shard_tree(self, tree: dict, prefix: str = "") -> dict:
        """This rank's blocks of a whole tree, each its own storage (the
        rest of the leaf can be freed)."""
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out[k] = (self.shard_tree(v, path) if isinstance(v, dict)
                      else self.keep(path, v))
        return out

    def gather_param(self, x: torch.Tensor, spec: Sequence,
                     keep: Sequence[str] = ()) -> torch.Tensor:
        """A leaf's block gathered over the axes ``spec`` names (but
        ``keep``), under autograd; the backward sums the cotangent over
        every axis but ``keep`` and keeps this rank's block."""
        plan = [(d, self.axes(_names(e))) for d, e in enumerate(spec)
                if _names(e) and not set(_names(e)) & set(keep)]
        red = self._without(keep)
        if not red:
            return x
        return _Gather.apply(x, plan, self.axes(red))

    def full_tree(self, tree: dict, prefix: str = "") -> dict:
        """A sharded tree gathered back to whole leaves (no autograd)."""
        out = {}
        with torch.no_grad():
            for k, v in tree.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    out[k] = self.full_tree(v, path)
                    continue
                for d, e in enumerate(self.specs[path]):
                    if _names(e):
                        v = _all_gather(v, self.axes(_names(e)), d)
                out[k] = v
        return out

    def gather_host(self, tree: dict, prefix: str = "") -> dict | None:
        """A sharded tree whole on the mesh's first rank, in host memory
        (None on the others), one leaf at a time: each leaf's blocks go
        to that rank alone (gloo gathers host tensors), so no rank holds
        more than one whole leaf beside the tree it builds. Every rank
        calls it. Leaves without a path in the specs (an optimizer's
        step) are taken from the first rank as they are."""
        world = self.axes(self.all)
        me = world.index == 0
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = self.gather_host(v, path)
                continue
            spec = self.specs.get(path, ())
            if not any(_names(e) for e in spec):
                out[k] = v.detach().cpu() if me else None
                continue
            x = v.detach()
            parts = cdist.gather(x, world)
            if parts is None:
                out[k] = None
                continue
            full = torch.empty(self.full_shape(x.shape, spec),
                               dtype=x.dtype)
            for r, part in enumerate(parts):
                slot = full
                for d, e in enumerate(spec):
                    if _names(e):
                        n = x.shape[d]
                        slot = slot.narrow(
                            d, self.index_of(r, _names(e)) * n, n)
                slot.copy_(part)
            out[k] = full
            del parts
        return out if me else None

    def owns(self, path: str) -> bool:
        """Whether this rank counts leaf ``path``'s block in a sum over the
        mesh: it is the first of the ranks that hold the same block (index
        0 on every axis the spec does not name)."""
        named = {a for e in self.specs[path] for a in _names(e)}
        return all(self.index((a,)) == 0 for a in self.all if a not in named)

    def global_sumsq(self, tree: dict) -> torch.Tensor:
        """The sum of squares of a sharded tree's elements, each counted
        once over the mesh (leaf sums in the reference's leaf order)."""
        from repro_torch.checkpoint.checkpointer import \
            _tree_flatten_with_names
        names, leaves, _ = _tree_flatten_with_names(tree)
        dev = leaves[0].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for n, x in zip(names, leaves):
            if self.owns(n):
                total = total + torch.sum(torch.square(x.float()))
        return _all_reduce(total, self.axes(self.all))

    # ------------------------------------------------------ activations
    def rows(self, B: int, S: int, *, gather_params: bool) -> "Rows":
        """The layout of a (B, S, ...) activation on this rank."""
        tp, dp = self.size(self.tp), self.size(self.dp)
        b_split, s_split = B % dp == 0, S % tp == 0
        return Rows(self, B, S, b_split, s_split,
                    self.index(self.dp) * (B // dp) if b_split else 0,
                    self.index(self.tp) * (S // tp) if s_split else 0,
                    B // dp if b_split else B, S // tp if s_split else S,
                    gather_params)


def _copy_dicts(tree: dict) -> dict:
    return {k: _copy_dicts(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class Rows:
    """One call's activation layout: the global (B, S), whether each
    splits, this rank's offsets and extents, and whether the parameters
    arrive as blocks to gather at use (training) or whole (serving's
    gathered copy)."""
    lay: Layout
    B: int
    S: int
    b_split: bool
    s_split: bool
    b0: int
    s0: int
    B_l: int
    S_l: int
    gather_params: bool

    # sequence over 'model'
    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if not self.s_split:
            return x
        return gather(x, dim, self.lay.axes(self.lay.tp))

    def own_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x.narrow(dim, self.s0, self.S_l) if self.s_split else x

    # batch over the data-parallel axes
    def gather_batch(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if not self.b_split:
            return x
        return gather(x, dim, self.lay.axes(self.lay.dp))

    def own_batch(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x.narrow(dim, self.b0, self.B_l) if self.b_split else x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A (B_l, S_l, ...) activation assembled whole."""
        return self.gather_batch(self.gather_seq(x, 1), 0)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        return self.own_seq(self.own_batch(x, 0), 1)

    @property
    def replicas(self) -> int:
        """How many ranks hold each of this rank's rows."""
        lay = self.lay
        return ((1 if self.b_split else lay.size(lay.dp))
                * (1 if self.s_split else lay.size(lay.tp))
                * lay.size(tuple(a for a in lay.all
                                 if a not in lay.dp + lay.tp)))

    # parameters at use
    def params(self, tree: dict, prefix: str, stacked: bool = True,
               skip: Sequence[str] = ()) -> dict:
        """A block's parameters gathered whole (when they arrive as
        blocks), in one collective. ``prefix``: the tree path of ``tree``
        in the model's parameters; ``stacked``: its leaves are one layer's
        slices of a stacked leaf; ``skip``: leaves (paths under ``tree``)
        left as blocks, which their caller gathers itself (``param``)."""
        if not self.gather_params:
            return tree
        lay = self.lay
        found: list = []

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{path}/{k}")
                elif f"{path}/{k}"[len(prefix) + 1:] not in skip:
                    found.append((node, k, f"{path}/{k}"))
        out = _copy_dicts(tree)
        walk(out, prefix)
        # the leaves in path order, whatever the tree's key order: the
        # sum's order over the mesh depends on a value's place in the
        # buffer, and a restored tree is ordered otherwise than a drawn one
        found.sort(key=lambda f: f[2])
        specs = [lay.specs[path][1:] if stacked else lay.specs[path]
                 for _, _, path in found]
        got = lay.gather_leaves([node[k] for node, k, _ in found], specs)
        for (node, k, _), g in zip(found, got):
            node[k] = g
        return out

    def param(self, x: torch.Tensor, path: str, keep: Sequence[str] = (),
              stacked: bool = True) -> torch.Tensor:
        """One leaf at use (a layer's slice when ``stacked``), gathered
        over the axes its spec names but ``keep`` (when it arrives as a
        block)."""
        if not self.gather_params:
            return x
        spec = self.lay.specs[path]
        return self.lay.gather_param(x, spec[1:] if stacked else spec, keep)

    def leaf(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """An unstacked leaf at use (the tables, the final norms)."""
        return self.param(x, path, stacked=False)
