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
    """Raise unless ``mesh`` is a DeviceMesh with named axes."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    if not mesh.mesh_dim_names:
        raise ValueError("the mesh needs mesh_dim_names (the axis names "
                         "data_axes and k_shard_axis refer to)")


def data_axes_of(mesh, model_axes: Sequence[str] = ()) -> tuple[str, ...]:
    """All mesh axes not reserved for the model: the SVM's worker grid."""
    return tuple(a for a in mesh.mesh_dim_names if a not in model_axes)


def num_shards(mesh, axes: Sequence[str]) -> int:
    return int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                        for a in axes], dtype=np.int64))


def axes_of(mesh, names: Sequence[str]) -> MeshAxes:
    """The ``MeshAxes`` of ``names`` on this rank. The first call for a
    (mesh, names) pair creates one process group for every combination of
    the other axes' coordinates, on every rank in the same order (as
    ``new_group`` requires), and keeps this rank's."""
    check_mesh(mesh)
    names = tuple(names)
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

