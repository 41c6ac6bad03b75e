"""Production and host meshes (``repro/launch/mesh.py`` in PyTorch).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the current process group, one SPMD process a rank, its axes named as
the reference's: ('data', 'model') on one pod, ('pod', 'data', 'model')
across pods. The caller creates the process group and picks its backend
(NCCL for one card a rank; gloo on the CPU and for ranks that share a
card); these functions only lay its ranks out. Functions, not constants:
importing this module touches no process group.
"""
from __future__ import annotations

import numpy as np


def _device_type(device) -> str:
    import torch
    return torch.device("cuda" if device is None else device).type


def _mesh(shape, axes, device):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    n = int(np.prod(shape, dtype=np.int64))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh "
                         f"({', '.join(axes)}) needs {n} ranks; the process "
                         f"group has {world}")
    return DeviceMesh(_device_type(device), torch.arange(n).view(*shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data',
    'model') under ``multi_pod``: 256 or 512 ranks, refused otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device=None):
    """A small mesh over the group's ranks (tests, the CPU, ranks sharing
    one card). ``device``: the ranks' device (the card unless given)."""
    return _mesh(tuple(shape), tuple(axes), device)
