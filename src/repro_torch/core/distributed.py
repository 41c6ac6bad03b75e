"""The paper's map-reduce architecture (Sec 4, Fig. 1) on a
``torch.distributed`` device mesh: port of ``repro/core/distributed.py``.

The reference runs one SPMD program under ``shard_map`` over a jax
``Mesh``; here every rank of a ``torch.distributed.device_mesh.DeviceMesh``
(with ``mesh_dim_names``) runs the same step on its own row block, and the
reductions are collectives over process groups:

  * ``data_axes_of`` / ``num_shards``: the worker grid, every mesh axis
    but the k-shard axis;
  * ``shard_rows``: this rank's row block of the padded training set, in
    the reference's layout (row-major over the data axes, offset
    ``stats.shard_row_offset``); ranks that differ only in the k axis hold
    the same block;
  * ``axes_of``: the role of ``shard_wrap``. A reduction over several mesh
    axes goes through one process group that spans them (``MeshAxes``),
    made once per (mesh, axes) and shared.
  * ``all_reduce``, ``all_gather``, ``gather``: every collective of the
    port, over a ``MeshAxes``.
  * on an ``AbstractMesh`` (``sharding/rules.py``: axis names and sizes,
    no ranks) ``axes_of`` gives the axes of the mesh's first rank, whose
    ``group`` is the mesh's ``CollectiveTally``: the three collectives
    then run nothing, record their kind, the bytes this rank sends and
    the count, and return their result's shape on the meta device (the
    dry run, ``launch/dryrun.py``, where the reference reads the compiled
    HLO's collectives).

The failure-tolerant reduction (the reference's ``live_weighted_psum``)
is ``stats.preduce(x, axes, live)``, which the steps call directly.

SPMD contract: every rank calls ``fit`` with the same host arrays, and
every output is replicated. The caller creates the process group and
picks its backend (NCCL for one card a rank; gloo on the CPU and for
ranks that share a card); the port never switches backend or device.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxes:
    """A set of mesh axes as this rank sees it: the process group spanning
    them, their size and this rank's linear index over them (row-major in
    the order of ``names``). ``ranks`` lists the group's global ranks in
    index order, for gathers that must come back in that order."""
    names: tuple[str, ...]
    group: object
    size: int
    index: int
    ranks: tuple[int, ...]


class CollectiveTally:
    """Collectives counted in place of being run (the group of every
    ``MeshAxes`` of an ``AbstractMesh``): by kind, the payload bytes one
    rank sends and the number of calls. Kinds as the reference's HLO
    names them ("all-gather", "all-reduce"), and "gather" (gloo's gather
    to one rank, the snapshot path)."""

    def __init__(self):
        self.bytes: dict[str, int] = {}
        self.ops: dict[str, int] = {}

    def record(self, kind: str, x) -> None:
        """Count one ``kind`` collective whose operand on this rank is
        ``x`` (a meta tensor: a real one on an abstract mesh would have
        no other ranks to meet)."""
        if not x.is_meta:
            raise ValueError("an abstract mesh counts collectives of meta "
                             f"tensors; got one on {x.device}")
        self.bytes[kind] = self.bytes.get(kind, 0) + x.numel() * \
            x.element_size()
        self.ops[kind] = self.ops.get(kind, 0) + 1

    def summary(self) -> dict:
        """{"total": bytes, "n_ops": calls, kind: bytes, ...}."""
        return {"total": sum(self.bytes.values()),
                "n_ops": sum(self.ops.values()), **self.bytes}


def _tally(axes) -> CollectiveTally | None:
    """The tally that takes ``axes``' collectives (an abstract mesh's),
    or None where they run."""
    return axes.group if isinstance(axes.group, CollectiveTally) else None


def all_reduce(x: torch.Tensor, axes: MeshAxes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` over ``axes``, into a new tensor."""
    tally = _tally(axes)
    if tally is not None:
        tally.record("all-reduce", x)
        return torch.empty_like(x)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=axes.group)
    return out


def all_gather(x: torch.Tensor, axes: MeshAxes, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over ``axes`` side by side along ``dim``, in the
    axes' index order."""
    tally = _tally(axes)
    if tally is not None:
        tally.record("all-gather", x)
        shape = list(x.shape)
        shape[dim] *= axes.size
        return x.new_empty(shape)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axes.size)]
    dist.all_gather(parts, x, group=axes.group)
    # all_gather fills in group-rank order; the blocks go in index order
    return torch.cat([parts[dist.get_group_rank(axes.group, r)]
                      for r in axes.ranks], dim=dim)


def gather(x: torch.Tensor, axes: MeshAxes) -> list | None:
    """Every rank's ``x`` over ``axes`` on the axes' first rank, in index
    order (None on the others); through host memory where the group is
    gloo's, which gathers host tensors."""
    tally = _tally(axes)
    if tally is not None:
        tally.record("gather", x)
        return [torch.empty_like(x) for _ in range(axes.size)]
    if dist.get_backend(axes.group) == "gloo":
        x = x.cpu()
    me = axes.index == 0
    parts = [torch.empty_like(x) for _ in range(axes.size)] if me else None
    dist.gather(x.contiguous(), parts, dst=axes.ranks[0], group=axes.group)
    if not me:
        return None
    return [parts[dist.get_group_rank(axes.group, r)] for r in axes.ranks]


# (id(mesh), names) -> (mesh, MeshAxes); the mesh is kept alive so that
# its id is not reused.
_AXES: dict = {}


def _release_groups() -> None:
    """Drop the cached axes and their process groups (run at exit, while
    the interpreter is whole). Freed during the interpreter's shutdown,
    beside the meshes' own groups, gloo groups now and then abort the
    process ("terminate called without an active exception", from the
    main thread with no Python frame: 21 of 2,400 four-rank exits under
    load, none of 2,400 with this). A group the caller has not destroyed
    stays referenced by torch.distributed and is not freed here."""
    _AXES.clear()
    gc.collect()


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a DeviceMesh with named axes, or an
    ``AbstractMesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if getattr(mesh, "tally", None) is not None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    if not mesh.mesh_dim_names:
        raise ValueError("the mesh needs mesh_dim_names (the axis names "
                         "data_axes and k_shard_axis refer to)")


def data_axes_of(mesh, model_axes: Sequence[str] = ()) -> tuple[str, ...]:
    """All mesh axes not reserved for the model: the SVM's worker grid."""
    return tuple(a for a in mesh.mesh_dim_names if a not in model_axes)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if getattr(mesh, "tally", None) is not None:
        return dict(zip(mesh.axis_names, mesh.shape_tuple))
    return {a: int(mesh.size(i))
            for i, a in enumerate(mesh.mesh_dim_names)}


def num_shards(mesh, axes: Sequence[str]) -> int:
    sizes = mesh_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes], dtype=np.int64))


def axes_of(mesh, names: Sequence[str]) -> MeshAxes:
    """The ``MeshAxes`` of ``names`` on this rank. The first call for a
    (mesh, names) pair creates one process group for every combination of
    the other axes' coordinates, on every rank in the same order (as
    ``new_group`` requires), and keeps this rank's. On an abstract mesh:
    the first rank's axes, counted by the mesh's tally."""
    check_mesh(mesh)
    names = tuple(names)
    tally = getattr(mesh, "tally", None)
    if tally is not None:
        sizes = mesh_sizes(mesh)
        for a in names:
            if a not in sizes:
                raise ValueError(f"{a!r} is not an axis of the mesh "
                                 f"{mesh.axis_names}")
        n = int(np.prod([sizes[a] for a in names], dtype=np.int64))
        return MeshAxes(names, tally, n, 0, tuple(range(n)))
    key = (id(mesh), names)
    if key in _AXES:
        return _AXES[key][1]
    dims = mesh.mesh_dim_names
    for a in names:
        if a not in dims:
            raise ValueError(f"{a!r} is not an axis of the mesh {dims}")
    idx = [dims.index(a) for a in names]
    rest = [d for d in range(len(dims)) if d not in idx]
    grid = mesh.mesh.permute(*rest, *idx)
    rows = grid.reshape(-1, int(np.prod([mesh.size(d) for d in idx],
                                        dtype=np.int64))).tolist()
    me = dist.get_rank()
    mine = None
    for row in rows:
        group = dist.new_group(row)
        if me in row:
            mine = MeshAxes(names, group, len(row), row.index(me),
                            tuple(row))
    if mine is None:
        raise ValueError(f"rank {me} is not in the mesh")
    if not _AXES:
        atexit.register(_release_groups)      # once a cache's life
    _AXES[key] = (mesh, mine)
    return mine


def pad_rows(X: np.ndarray, target: np.ndarray, shards: int,
             multiple: int = 8):
    """Zero-pad rows to a multiple of (shards * multiple); returns host
    arrays (X, target, mask). Padded rows: X-row = 0, target = 0,
    mask = 0."""
    N = X.shape[0]
    chunk = shards * multiple
    Np = ((N + chunk - 1) // chunk) * chunk
    pad = Np - N
    Xp = np.concatenate([X, np.zeros((pad,) + X.shape[1:], X.dtype)], axis=0)
    tp = np.concatenate([target, np.zeros((pad,), target.dtype)], axis=0)
    mask = np.concatenate([np.ones((N,), np.float32),
                           np.zeros((pad,), np.float32)], axis=0)
    return Xp, tp, mask


def shard_rows(axes: MeshAxes | None, X: np.ndarray, target: np.ndarray):
    """This rank's block (X, target, mask) of the training set padded as
    the reference pads it (``pad_rows`` over all data shards), the rows of
    data shard ``axes.index``; the whole padded set without a mesh."""
    shards = 1 if axes is None else axes.size
    Xp, tp, mask = pad_rows(X, target, shards)
    if axes is None:
        return Xp, tp, mask
    n = Xp.shape[0] // shards
    sl = slice(axes.index * n, (axes.index + 1) * n)
    return Xp[sl], tp[sl], mask[sl]

