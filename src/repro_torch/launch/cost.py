"""FLOP and byte accounting of one rank's step: the port's counterpart of
``repro/launch/hlo_cost.py``.

The reference reads the compiled per-partition HLO. Eager torch has no
compiled program, so ``CostCounter`` is a ``TorchDispatchMode`` that
counts every aten op as it runs (on the meta device in the dry run, where
nothing is computed), with ``hlo_cost``'s rules:

  * flops: a product (mm, addmm, bmm, baddbmm, convolution) counts
    2 * |result| * |contracting|; an elementwise op |result|; a reduction
    |input|; a Cholesky n^3 / 3 and a triangular solve n^2 a right-hand
    side;
  * bytes: operands plus result. A view moves nothing. An index or slice
    read (index, gather, index_select, embedding) counts the moved slice
    twice (read and written), not the table; an in-place index write
    (index_put_, index_copy_, scatter, index_add_, a copy into a view)
    counts the update twice, not the buffer. These are the semantics
    ``tests/test_hlo_cost_semantics.py`` pins for the reference.

Eager torch has no loop bodies to multiply out: each layer of a Python
loop is counted as it runs, and a block recomputed under checkpointing
is counted again when it is.

What it does not count: fusion. Each eager op reads its operands from
memory and writes its result there, where a compiled program keeps the
intermediates of a fusion on chip, so ``bytes`` is an upper bound on a
fused program's. Collectives are counted apart, by the abstract mesh's
tally (``core.distributed.CollectiveTally``); the empty results they
hand back count nothing here, nor does laying a gathered buffer's blocks
into whole leaves (``sharding/layout.py``'s ``_GatherLeaves``), which on
an abstract mesh is skipped.
"""
from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "detach", "alias",
         "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
         "is_same_size", "_has_compatible_shallow_copy_type", "resize_",
         "set_", "record_stream", "_unsafe_view"}
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "dot", "vdot",
             "mv", "addmv", "_scaled_mm"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "linalg_vector_norm", "norm", "var", "std",
               "var_mean", "std_mean", "any", "all", "argmax", "argmin",
               "cumsum", "cumprod", "_softmax", "_log_softmax", "topk",
               "sort", "nansum", "count_nonzero", "aminmax", "cummax"}
_INDEX_READS = {"index", "gather", "index_select", "embedding",
                "take_along_dim", "take", "masked_select"}
_INDEX_WRITES = {"index_put", "index_put_", "_index_put_impl_",
                 "index_copy", "index_copy_", "scatter", "scatter_",
                 "scatter_add", "scatter_add_", "index_add", "index_add_",
                 "scatter_reduce", "scatter_reduce_", "masked_scatter",
                 "masked_scatter_"}
_BIASED = {"addmm", "baddbmm", "addbmm", "addmv"}


def _tensors(*groups) -> list:
    """The tensors among ``groups``' items and their lists (an aten op's
    arguments and results nest no deeper)."""
    out = []
    for g in groups:
        for x in g:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _numel(shape) -> int:
    return math.prod(shape)


def op_cost(func, args, kwargs, out) -> tuple[float, float]:
    """(flops, bytes) of one aten op by the rules above."""
    name = func.overloadpacket.__name__
    if name in _FREE or getattr(func, "is_view", False):
        return 0.0, 0.0
    ins = _tensors(args, kwargs.values())
    outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
    res_bytes = sum(_nbytes(t) for t in outs)
    res_elems = sum(t.numel() for t in outs)
    in_bytes = sum(_nbytes(t) for t in ins)
    if name in _PRODUCTS:
        a = args[1] if name in _BIASED else args[0]
        flops = 2.0 * res_elems * (a.shape[-1] if a.dim() else 1)
        if name in _BIASED:
            flops += res_elems
        return flops, in_bytes + res_bytes
    if name == "convolution":     # weight (out, in / groups, *kernel)
        return 2.0 * res_elems * _numel(args[1].shape[1:]), \
            in_bytes + res_bytes
    if name in ("linalg_cholesky_ex", "cholesky"):
        A = args[0]
        n = A.shape[-1]
        return _numel(A.shape[:-2]) * n ** 3 / 3.0, in_bytes + res_bytes
    if name in ("cholesky_solve", "linalg_solve_triangular",
                "triangular_solve"):
        n = args[1].shape[-1]
        nrhs = res_elems / max(n, 1)
        mult = 2.0 if name == "cholesky_solve" else 1.0
        return mult * n * n * nrhs, in_bytes + res_bytes
    if name in _INDEX_READS:
        return 0.0, 2.0 * res_bytes
    if name in _INDEX_WRITES:
        upd = args[2] if name.startswith(("index_put", "_index_put")) \
            else ins[-1]
        adds = name.startswith(("scatter_add", "index_add", "scatter_reduce"))
        return (float(upd.numel()) if adds else 0.0), 2.0 * _nbytes(upd)
    if name == "copy_":
        return 0.0, 2.0 * _nbytes(args[1])
    if name in _REDUCTIONS:
        return float(ins[0].numel()) if ins else 0.0, in_bytes + res_bytes
    if torch.Tag.pointwise in func.tags:
        return float(res_elems), in_bytes + res_bytes
    return 0.0, in_bytes + res_bytes


class CostCounter(TorchDispatchMode):
    """Counts the flops and bytes of every aten op run while it is
    active: ``with CostCounter() as c: step(...)``; then ``c.flops``,
    ``c.bytes`` and ``c.by_op`` ({op: [calls, flops, bytes]})."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: dict = defaultdict(lambda: [0, 0.0, 0.0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, nbytes = op_cost(func, args, kwargs, out)
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op[func.overloadpacket.__name__]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    def top(self, n: int = 8, key: int = 1) -> list:
        """The ``n`` ops with most flops (key 1) or bytes (key 2)."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][key])
        return [(k, *v) for k, v in rows[:n]]
