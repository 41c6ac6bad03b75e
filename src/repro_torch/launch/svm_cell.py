"""The paper's own workload as a cell: one PEMSVM iteration (the Fig.-1
map-reduce) at paper scale (``repro/launch/svm_cell.py`` in PyTorch).

Shapes follow paper Table 3:

  svm_dna      N=25.6M  K=800   CLS   (dna: 25M x 800)
  svm_alpha    N=262144 K=500   CLS   (alpha: 250k x 500)
  svm_mnist8m  N=4.19M  K=784   MLT10 (mnist8m: 4M x 798 [784+pad])
  svm_year     N=262144 K=96    SVR   (year: 250k x 90 [+pad])

Options (``opts``, strings as the CLI gives them): mode=EM|MC (MC for
MLT, EM otherwise: the paper's picks), triangle=0|1, reduce_dtype=
bfloat16, k_shard=1 (the 2-D Sigma statistic over the model axis),
dtype=bfloat16 (input compression), lam, backend (the statistics'
kernels backend: "ref" runs the plain version on the card).

One builder serves the dry run and the card. On a mesh (a ``DeviceMesh``,
or an ``AbstractMesh`` on the meta device, whose collectives are counted)
the step reduces over the data axes as ``core.distributed`` does; without
one (``mesh=None``) it is one device holding ``opts["shards"]``'s share
of the rows (1: all of them), the statistics unreduced. On the card the
step runs ``fused_stats`` (em_hinge, mc_hinge or em_svr, over X or, under
k_shard, a column window).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distributed, linear, multiclass, svr
from repro_torch.core.linear import SVMData
from repro_torch.launch.specs import Struct

SVM_SHAPES = {
    "svm_dna": dict(N=25_600_000, K=800, task="CLS"),
    "svm_alpha": dict(N=262_144, K=500, task="CLS"),
    "svm_mnist8m": dict(N=4_194_304, K=784, task="MLT", M=10),
    "svm_year": dict(N=262_144, K=96, task="SVR"),
}


class SVMCell(NamedTuple):
    """``step(data, state, key) -> (state, aux)`` on this rank's rows;
    ``structs``: (data, state, key) shapes of the arguments, global on a
    mesh (a rank's rows are N / shards) and one device's share without;
    ``specs``: their spec tuples over the mesh (the reference's
    ``PartitionSpec`` positions); ``shards``: the data shards."""
    step: object
    structs: tuple
    specs: tuple
    shards: int


def build_svm_cell(arch: str, shape_name: str, mesh, opts: dict) -> SVMCell:
    """The cell ``shape_name`` of ``SVM_SHAPES`` on ``mesh`` (see the
    module docstring); ``arch`` is the reference's label ("pemsvm")."""
    del arch
    spec = SVM_SHAPES[shape_name]
    N, K, task = spec["N"], spec["K"], spec["task"]
    M = spec.get("M", 2)
    mode = opts.get("mode", "MC" if task == "MLT" else "EM")
    dtype = getattr(torch, opts.get("dtype", "float32"))
    k_shard = bool(int(opts.get("k_shard", 0)))

    if mesh is None:
        if k_shard:
            raise ValueError("k_shard needs a mesh with a 'model' axis")
        data_axes, axes, k_axis = (), None, None
        shards = int(opts.get("shards", 1))
    else:
        names = tuple(mesh.mesh_dim_names)
        if k_shard:
            data_axes = tuple(a for a in names if a != "model")
            k_axis = distributed.axes_of(mesh, ("model",))
            # The 2-D statistic splits Sigma columns over 'model'; the
            # windowed kernels need the statistic width divisible
            # (pad_features_to is the user-facing fix: _k_block raises).
            assert K % k_axis.size == 0, (
                f"K={K} not divisible by model axis {k_axis.size}; "
                "pad with data.pipeline.pad_features_to")
        else:
            data_axes, k_axis = names, None
        axes = distributed.axes_of(mesh, data_axes)
        shards = axes.size
    assert N % shards == 0, (N, shards)

    common = dict(mode=mode, lam=float(opts.get("lam", 1.0)), eps=1e-6,
                  jitter=1e-7, axes=axes,
                  triangle=bool(int(opts.get("triangle", 1))),
                  backend=opts.get("backend"),
                  reduce_dtype=opts.get("reduce_dtype"),
                  k_shard_axis=k_axis)
    if task == "CLS":
        def step(data, state, key):
            return linear.cls_step(data, state, key, **common)
        state_struct, state_spec = Struct((K,), torch.float32), (None,)
        tdtype = torch.float32
    elif task == "SVR":
        def step(data, state, key):
            return svr.svr_step(data, state, key, eps_ins=1e-3, **common)
        state_struct, state_spec = Struct((K,), torch.float32), (None,)
        tdtype = torch.float32
    else:
        def step(data, state, key):
            return multiclass.mlt_step(data, state, key, num_classes=M,
                                       **common)
        state_struct = Struct((M, K), torch.float32)
        state_spec = (None, None)
        tdtype = torch.int32

    rows = N if mesh is not None else N // shards   # global on a mesh
    row = (data_axes or None,)
    structs = (SVMData(X=Struct((rows, K), dtype),
                       target=Struct((rows,), tdtype),
                       mask=Struct((rows,), torch.float32)),
               state_struct, Struct((2,), torch.int64))
    specs = (SVMData(X=(data_axes or None, None), target=row, mask=row),
             state_spec, (None,))
    return SVMCell(step, structs, specs, shards)


def model_flops(shape_name: str) -> float:
    """The reference's model flops of one iteration: per class,
    2 N K^2 + 6 N K + K^3 / 3 (paper Sec 4.3: the Sigma statistic
    dominates)."""
    sp = SVM_SHAPES[shape_name]
    m = sp.get("M", 1) if sp["task"] == "MLT" else 1
    return float(m * (2 * sp["N"] * sp["K"] ** 2 + 6 * sp["N"] * sp["K"]
                      + sp["K"] ** 3 / 3))
