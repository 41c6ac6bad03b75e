"""Dry run of one (architecture x input shape) cell on the production mesh:
one rank's step on the meta device, its flops, bytes and collectives
counted, and the roofline terms of an H100 (``repro/launch/dryrun.py`` in
PyTorch).

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads the compiled HLO. The port runs the step itself, as the
mesh's first rank, on the meta device, where nothing is computed or
allocated: the mesh is an ``AbstractMesh`` of ``launch/mesh.py``'s shape
(16 x 16 ('data', 'model'), or 2 x 16 x 16 ('pod', 'data', 'model') under
``--multi-pod``), the parameters, optimizer state, batch and caches are
this rank's blocks by ``launch/specs.py``, every collective is counted in
place of being run (``core.distributed.CollectiveTally``) and every aten
op by ``launch/cost.py``. The PEMSVM cells go through ``svm_cell``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k \
      [--multi-pod] [--out runs/dryrun] [--opt k=v ...]

Emits one JSON a cell, named as the reference names it, with the
reference's keys where they mean the same: ``flops_per_device``,
``bytes_per_device``, ``collectives_per_device``, ``memory``, ``terms``
(with ``dominant``), ``model_flops``, ``useful_flops_ratio``, ``lower_s``
(building the cell) and ``total_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import SHAPES, applicable, get_config
from repro_torch.launch import specs as sp
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.svm_cell import SVM_SHAPES, build_svm_cell
from repro_torch.launch.svm_cell import model_flops as svm_model_flops
from repro_torch.launch.sweep import cell_path
from repro_torch.sharding.rules import AbstractMesh, mesh_sizes

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W):
PEAK_FLOPS_BF16 = 989e12     # tensor cores, bf16: the LM cells
PEAK_FLOPS_FP32 = 67e12      # CUDA cores, fp32: the SVM cells (no TF32)
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80 * 2 ** 30     # device memory
# Collectives: one 400 Gb/s NDR InfiniBand link a GPU (DGX H100), 50 GB/s.
# Every mesh axis of 16 leaves the host's 8-GPU NVLink domain (450 GB/s
# each way), so the slower link bounds a collective over it.
NET_BW = 50e9                # bytes/s a GPU


def abstract_mesh(multi_pod: bool) -> AbstractMesh:
    """``launch/mesh.py``'s production shapes, without ranks."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def block_shape(mesh, shape, spec) -> tuple:
    """A leaf's block on one rank: each dim over the axes its spec names."""
    sizes = mesh_sizes(mesh)
    out = []
    for n, e in zip(shape, spec or (None,) * len(shape)):
        names = () if e is None else (e,) if isinstance(e, str) else e
        out.append(n // int(np.prod([sizes[a] for a in names],
                                    dtype=np.int64)))
    return tuple(out)


def _is_node(tree) -> bool:
    return isinstance(tree, dict) or (isinstance(tree, tuple) and
                                      not isinstance(tree, sp.Struct))


def _pairs(structs, specs):
    """(struct, spec) of every leaf of a (struct tree, spec tree)."""
    if isinstance(structs, dict):
        for k in structs:
            yield from _pairs(structs[k], specs[k])
    elif _is_node(structs):
        for s, p in zip(structs, specs):
            yield from _pairs(s, p)
    else:
        yield structs, specs


def _blocks(mesh, structs, specs):
    """Meta tensors of this rank's blocks, in the structs' tree."""
    if isinstance(structs, dict):
        return {k: _blocks(mesh, structs[k], specs[k]) for k in structs}
    if _is_node(structs):
        vals = [_blocks(mesh, s, p) for s, p in zip(structs, specs)]
        return (type(structs)(*vals) if hasattr(structs, "_fields")
                else tuple(vals))
    return torch.empty(block_shape(mesh, structs.shape, specs),
                       dtype=structs.dtype, device="meta")


def argument_bytes(mesh, structs, specs) -> int:
    """The bytes of one rank's blocks of a (struct tree, spec tree)."""
    return sum(int(np.prod(block_shape(mesh, s.shape, p), dtype=np.int64))
               * torch.empty((), dtype=s.dtype).element_size()
               for s, p in _pairs(structs, specs))


@dataclasses.dataclass
class Cell:
    """A built cell: ``run()`` is one rank's step on the meta device;
    ``structs`` / ``specs`` its arguments (the bytes a rank holds)."""
    mesh: AbstractMesh
    run: object
    structs: tuple
    specs: tuple


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               opts: dict) -> Cell:
    """The cell's step and arguments on the production mesh."""
    mesh = abstract_mesh(multi_pod)
    if arch.startswith("pemsvm"):
        svm = build_svm_cell(arch, shape_name, mesh, opts)
        args = _blocks(mesh, svm.structs, svm.specs)
        return Cell(mesh, lambda: svm.step(*args), svm.structs, svm.specs)
    from repro_torch.models import build_model
    from repro_torch.serving import make_decode_step, make_prefill_step
    from repro_torch.training import AdamWConfig, make_train_step
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ctx = sp.make_ctx(mesh, shape)
    model = build_model(
        cfg, ctx, "meta",
        q_chunk=int(opts.get("q_chunk", 1024)),
        kv_chunk=int(opts.get("kv_chunk", 1024)),
        ssm_chunk=int(opts.get("ssm_chunk", 256)),
        skip_masked_blocks=bool(int(opts.get("skip_masked_blocks", 0))),
        remat_policy=opts.get("remat_policy", "nothing"),
        seq_parallel_attn=bool(int(opts.get("seq_attn", 0))))

    if shape.kind == "train":
        pstructs, pspecs = sp.param_struct_specs(cfg, ctx)
        ostructs, ospecs = sp.opt_state_specs(pstructs, pspecs)
        bstructs, bspecs = sp.batch_specs(cfg, shape, ctx, with_labels=True)
        structs = ({"params": pstructs, "opt": ostructs}, bstructs)
        specs = ({"params": pspecs, "opt": ospecs}, bspecs)
        state, batch = _blocks(mesh, structs, specs)
        model.use_params(state["params"])
        step = make_train_step(
            model, AdamWConfig(),
            remat=bool(int(opts.get("remat", 1))),
            loss_chunk=int(opts.get("loss_chunk", 512)),
            microbatches=int(opts.get("microbatches", 1)))
        return Cell(mesh, lambda: step(state, batch), structs, specs)

    # Serving holds the weights in the compute dtype, as param_spec's
    # blocks: the reference's serve_fsdp=0 / serve_tp=0 levers (weights
    # replicated over an axis) have no layout in the port.
    if "serve_fsdp" in opts or "serve_tp" in opts:
        raise ValueError("serve_fsdp / serve_tp: the port's layout holds "
                         "parameters as param_spec's blocks only")
    pstructs, pspecs = sp.param_struct_specs(cfg, ctx, dtype=cfg.dtype)
    model.use_params(_blocks(mesh, pstructs, pspecs))
    model.compute_params    # the serving copy, made before the count
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        bstructs, bspecs = sp.batch_specs(cfg, shape, ctx, with_labels=False)
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                 for k, v in bstructs.items()}
        step = make_prefill_step(model, cache_len=S)
        return Cell(mesh, lambda: step(batch), (pstructs, bstructs),
                    (pspecs, bspecs))

    # decode: one new token against a seq_len cache
    cstructs, cspecs = sp.cache_specs(cfg, shape, ctx)
    caches = model.init_cache(B, S, getattr(torch, cfg.dtype))
    tok_struct = sp.Struct((B, 1), torch.int32)
    tok_spec = ctx.spec((B, 1), ctx.dp_axes, None)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    step = make_decode_step(model)
    return Cell(mesh, lambda: step(tokens, S - 1, caches),
                (pstructs, tok_struct, cstructs),
                (pspecs, tok_spec, cspecs))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: dict | None = None) -> dict:
    """The cell's record (see the module docstring); a cell that raises
    is recorded with its error, one that ``applicable`` rejects as
    skipped."""
    opts = opts or {}
    is_svm = arch.startswith("pemsvm")
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "opts": opts, "ok": False}
    if not is_svm:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        runs, reason = applicable(cfg, shape)
        if not runs:
            rec.update(skipped=True, reason=reason, ok=True)
            return rec

    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, multi_pod, opts)
        rec["lower_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        with CostCounter() as cost:
            cell.run()
        rec["run_s"] = round(time.time() - t1, 1)
        rec["flops_per_device"] = cost.flops
        rec["bytes_per_device"] = cost.bytes
        rec["top_ops"] = [list(r) for r in cost.top(6)]
        arg = argument_bytes(cell.mesh, cell.structs, cell.specs)
        rec["memory"] = {"argument_bytes": arg,
                         "fits_hbm": bool(arg < HBM_BYTES)}
        rec["collectives_per_device"] = cell.mesh.tally.summary()

        peak = PEAK_FLOPS_FP32 if is_svm else PEAK_FLOPS_BF16
        coll = rec["collectives_per_device"]["total"]
        rec["terms"] = {
            "compute_s": rec["flops_per_device"] / peak,
            "memory_s": rec["bytes_per_device"] / HBM_BW,
            "collective_s": coll / NET_BW,
        }
        rec["terms"]["dominant"] = max(rec["terms"],
                                       key=lambda k: rec["terms"][k])
        # model flops: 6ND for LM cells (2ND for inference); per SVM
        # iteration N*K^2 + 3NK (+K^3/3 solve), the reference's formulas
        if is_svm:
            nd = svm_model_flops(shape_name)
        else:
            tokens = shape.global_batch * (
                shape.seq_len if shape.kind != "decode" else 1)
            nd = 6 * cfg.active_params() * tokens
            if shape.kind in ("prefill", "decode"):
                nd = nd / 3
        rec["model_flops"] = float(nd)
        global_flops = rec["flops_per_device"] * chips
        rec["useful_flops_ratio"] = (rec["model_flops"] / global_flops
                                     if global_flops else 0.0)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    choices=sorted(SHAPES) + sorted(SVM_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--opt", action="append", default=[],
                    help="k=v model/step options (q_chunk, remat, ...)")
    args = ap.parse_args(argv)
    opts = dict(kv.split("=", 1) for kv in args.opt)

    rec = run_cell(args.arch, args.shape, args.multi_pod, opts)
    os.makedirs(args.out, exist_ok=True)
    with open(cell_path(args.out, args.arch, args.shape, args.multi_pod,
                        args.opt), "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=2))
    if not rec["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
