"""Elastic scaling: move a solver state between meshes, the port's form of
``repro/runtime/elastic.py``.

A pod loses nodes, the job restarts on the surviving slice (or a grown
one), and the last committed checkpoint is restored onto the new mesh.
Nothing in the checkpoint is mesh-specific (arrays are stored as logical
host tensors, ``repro_torch.checkpoint``), so elasticity is a restore-time
placement. The solver's state is replicated on a
``torch.distributed`` DeviceMesh (every rank holds the whole weight), so
placing it for a mesh is placing the same host array on this rank's
device on every rank.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (_tree_flatten_with_names,
                                                 _tree_unflatten)


def _placement(target) -> torch.device:
    """This rank's device for ``target``: a ``torch.device`` (or its
    string), or a DeviceMesh, whose ranks each place on their current
    device of the mesh's type."""
    if isinstance(target, (torch.device, str)):
        return torch.device(target)
    kind = target.device_type
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def remesh(tree: Any, target) -> Any:
    """Every leaf of ``tree`` (host arrays or tensors) as a tensor on this
    rank's device for ``target`` (``_placement``), through a host copy, as
    the reference re-shards through the host: on a real re-deploy the
    host copy is the checkpoint."""
    dev = _placement(target)
    _, leaves, treedef = _tree_flatten_with_names(tree)
    out = [torch.from_numpy(np.array(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x)).to(dev)
        for x in leaves]
    return _tree_unflatten(treedef, out)


def scale_batch_schedule(global_batch: int, old_workers: int,
                         new_workers: int, *, keep_global: bool = True):
    """When the worker count changes, either keep the global batch (per-
    worker batch changes; optimization trajectory preserved) or keep the
    per-worker batch (throughput preserved; LR should rescale). Returns
    (global_batch, lr_scale)."""
    if keep_global:
        assert global_batch % new_workers == 0, (global_batch, new_workers)
        return global_batch, 1.0
    per = global_batch // old_workers
    new_global = per * new_workers
    return new_global, new_workers / old_workers
