"""The port's dry run (``repro_torch.launch.{cost,svm_cell,dryrun,sweep}``)
on the CPU: the counter's semantics, a rank's argument bytes, the PEMSVM
cells, the sweep's names and cache, and the memory of the largest
config's cheapest cell.

Bands, stated before the runs: argument bytes exact; a small SVM cell's
counted flops within 5 % of the reference's model-flops formula; the
deepseek-v2-236b decode_32k cell on 16 x 16 raises the peak RSS of its
process by under 1 GiB over what it was after ``import torch``.

Production-size configs are built on the meta device only; the counted
steps run at reduced configs, apart from that one cell, which runs in a
subprocess. No process group is opened: an ``AbstractMesh`` counts the
collectives.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from conftest import reduce_cfg
from repro.launch import sweep as rsweep
from repro_torch.configs import SHAPES, applicable, get_config, list_archs
from repro_torch.launch import dryrun, specs, sweep
from repro_torch.launch import svm_cell
from repro_torch.launch.cost import CostCounter
from repro_torch.models import build_model
from repro_torch.sharding.rules import AbstractMesh
from repro_torch.training import AdamWConfig, make_train_step
from torch_family_util import one_torch_thread  # noqa: F401

SRC = str(Path(__file__).resolve().parents[1] / "src")
META = "meta"


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ------------------------------------------------------------- counter
def test_counts_products():
    a, b = _t(32, 64), _t(64, 16)
    with CostCounter() as c:
        a @ b
    assert c.flops == 2 * 32 * 64 * 16
    assert c.bytes == 4 * (32 * 64 + 64 * 16 + 32 * 16)
    with CostCounter() as c:
        torch.bmm(_t(3, 4, 5), _t(3, 5, 6))
    assert c.flops == 2 * 3 * 4 * 5 * 6
    with CostCounter() as c:
        torch.einsum("bij,bjk->bik", _t(3, 4, 5), _t(3, 5, 6))
    assert c.flops == 2 * 3 * 4 * 5 * 6
    with CostCounter() as c:
        torch.tanh(_t(10, 10))
    assert (c.flops, c.bytes) == (100, 800)


def test_gather_counts_slice_not_table():
    V, D, B = 50_000, 64, 4
    table, idx = _t(V, D), _t(B, dtype=torch.long)
    with CostCounter() as c:
        table[idx]
    assert c.bytes == 2 * B * D * 4           # the slice, read and written
    with CostCounter() as c:
        torch.nn.functional.embedding(idx, table)
    assert c.bytes == 2 * B * D * 4


def test_index_write_counts_update_not_buffer():
    S, D = 100_000, 64
    buf, upd = _t(S, D), _t(1, D)
    with CostCounter() as c:
        buf[5:6] = upd
    assert c.bytes == 2 * D * 4
    with CostCounter() as c:
        buf.index_put_((_t(1, dtype=torch.long),), upd)
    assert c.bytes == 2 * D * 4


def test_checkpointed_block_counted_twice():
    w = _t(64, 64).requires_grad_(True)
    x = _t(8, 64)

    def block(x):
        return torch.tanh(x @ w)

    with CostCounter() as plain:
        block(x).sum().backward()
    with CostCounter() as remat:
        checkpoint(block, x, use_reentrant=False).sum().backward()
    assert plain.by_op["mm"][0] == 2          # forward, d/dw
    assert remat.by_op["mm"][0] == 3          # forward, again, d/dw
    assert remat.by_op["mm"][1] == 3 * 2 * 8 * 64 * 64
    assert remat.by_op["tanh"][0] == 2 * plain.by_op["tanh"][0]


def test_remat_train_step_counts_the_blocks_again():
    """Under remat every period's forward runs again in the backward pass:
    two more periods add their forward's flops twice to a remat step and
    once to a plain one. (Torch's checkpoint stops a recomputation once it
    has the tensors the backward needs; with that early stop off, the
    whole forward runs again.)"""
    base = get_config("smollm-135m")
    B, S = 2, 64
    batch = {"tokens": _t(B, S, dtype=torch.int32),
             "labels": _t(B, S, dtype=torch.int32)}

    def count(n_layers, remat=None):
        cfg = reduce_cfg(base, n_layers=n_layers)
        model = build_model(cfg, device=META, q_chunk=16, kv_chunk=16)
        params = model.init(0)
        with CostCounter() as c:
            if remat is None:
                model.hidden_seq(batch, params=params)
            else:
                opt = {"m": params, "v": params,
                       "step": _t(dtype=torch.int32)}
                with set_checkpoint_early_stop(False):
                    make_train_step(model, AdamWConfig(), remat=remat)(
                        {"params": params, "opt": opt}, batch)
        return c.flops

    fwd = count(4) - count(2)
    assert fwd > 0
    assert (count(4, True) - count(2, True)) - \
        (count(4, False) - count(2, False)) == fwd


# --------------------------------------------------------- argument bytes
def _shard_bytes(mesh, structs, spec_tree) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape_tuple))

    def walk(s, p):
        if isinstance(s, dict):
            return sum(walk(s[k], p[k]) for k in s)
        if isinstance(s, tuple) and not isinstance(s, specs.Struct):
            return sum(walk(a, b) for a, b in zip(s, p))
        n = int(np.prod(s.shape, dtype=np.int64))
        for e in p or ():
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                assert n % sizes[a] == 0
                n //= sizes[a]
        return n * torch.empty((), dtype=s.dtype).element_size()
    return walk(structs, spec_tree)


def _expected_args(arch, shape_name, mesh):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ctx = specs.make_ctx(mesh, shape)
    if shape.kind == "train":
        p, ps = specs.param_struct_specs(cfg, ctx)
        o, os_ = specs.opt_state_specs(p, ps)
        b, bs = specs.batch_specs(cfg, shape, ctx, with_labels=True)
        return (_shard_bytes(mesh, p, ps) + _shard_bytes(mesh, o, os_)
                + _shard_bytes(mesh, b, bs))
    p, ps = specs.param_struct_specs(cfg, ctx, dtype=cfg.dtype)
    if shape.kind == "prefill":
        b, bs = specs.batch_specs(cfg, shape, ctx, with_labels=False)
        return _shard_bytes(mesh, p, ps) + _shard_bytes(mesh, b, bs)
    c, cs = specs.cache_specs(cfg, shape, ctx)
    B = shape.global_batch
    tok = specs.Struct((B, 1), torch.int32)
    return (_shard_bytes(mesh, p, ps) + _shard_bytes(mesh, c, cs)
            + _shard_bytes(mesh, tok, ctx.spec((B, 1), ctx.dp_axes, None)))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_argument_bytes_are_the_shards(arch, multi_pod):
    """A rank's argument bytes, from the specs alone (the step does not
    run), equal the sum of its shard sizes, for every applicable shape."""
    mesh = dryrun.abstract_mesh(multi_pod)
    for shape_name in SHAPES:
        if not applicable(get_config(arch), SHAPES[shape_name])[0]:
            continue
        cell = dryrun.build_cell(arch, shape_name, multi_pod, {})
        got = dryrun.argument_bytes(cell.mesh, cell.structs, cell.specs)
        assert got == _expected_args(arch, shape_name, mesh), shape_name
        assert cell.mesh.tally.summary()["n_ops"] == 0   # nothing ran


# ------------------------------------------------------------- SVM cells
def test_svm_shapes_are_the_reference():
    from repro.launch.svm_cell import SVM_SHAPES as REF
    assert svm_cell.SVM_SHAPES == REF
    for multi_pod, chips in ((False, 256), (True, 512)):
        mesh = dryrun.abstract_mesh(multi_pod)
        for name, sp in REF.items():
            cell = svm_cell.build_svm_cell("pemsvm", name, mesh, {})
            assert cell.shards == chips
            X = dryrun.block_shape(mesh, cell.structs[0].X.shape,
                                   cell.specs[0].X)
            assert X == (sp["N"] // chips, sp["K"])
        # the 2-D statistic: data shards over every axis but 'model'
        cell = svm_cell.build_svm_cell("pemsvm", "svm_year", mesh,
                                       {"k_shard": "1"})
        assert cell.shards == chips // 16


def test_small_svm_cell_flops_near_model_flops(monkeypatch):
    monkeypatch.setitem(svm_cell.SVM_SHAPES, "svm_small",
                        dict(N=4096, K=256, task="CLS"))
    cell = svm_cell.build_svm_cell("pemsvm", "svm_small", None, {})
    data, state, key = cell.structs
    args = (type(data)(*[torch.empty(s.shape, dtype=s.dtype, device=META)
                         for s in data]),
            torch.empty(state.shape, device=META),
            torch.empty(key.shape, dtype=key.dtype, device=META))
    with CostCounter() as c:
        cell.step(*args)
    want = svm_cell.model_flops("svm_small")
    assert abs(c.flops / want - 1) <= 0.05, c.flops / want


def test_svm_cell_counts_its_reduction():
    rec = dryrun.run_cell("pemsvm", "svm_alpha", False)
    assert rec["ok"], rec.get("error")
    K = 500
    coll = rec["collectives_per_device"]
    # the packed triangle and b, plus the objective's and diagnostics'
    # scalars, all in float32
    assert coll["all-reduce"] >= 4 * (K * (K + 1) // 2 + K)
    assert rec["terms"]["dominant"] in ("compute_s", "memory_s",
                                        "collective_s")
    assert 0.5 < rec["useful_flops_ratio"] < 1.5


def test_lm_cell_on_abstract_mesh_counts_collectives():
    """A reduced dense config's train step on a 2 x 2 abstract mesh, on the
    meta device: its gathers at use and its sums are counted."""
    cfg = reduce_cfg(get_config("smollm-135m"))
    mesh = AbstractMesh((2, 2), ("data", "model"))
    ctx = specs.make_ctx(mesh)
    model = build_model(cfg, ctx, META, q_chunk=16, kv_chunk=16)
    params = model.init(0)
    opt = {"m": params, "v": params, "step": _t(dtype=torch.int32)}
    batch = {"tokens": _t(2, 32, dtype=torch.int32),
             "labels": _t(2, 32, dtype=torch.int32)}
    step = make_train_step(model, AdamWConfig(), remat=True)
    with CostCounter() as c:
        step({"params": params, "opt": opt}, batch)
    tally = mesh.tally.summary()
    assert tally["all-gather"] > 0 and tally["all-reduce"] > 0
    assert c.flops > 0


# ----------------------------------------------------------------- sweep
def test_cell_paths_are_the_reference():
    for arch, shape in sweep.cells():
        assert sweep.baseline_opts(arch, shape) == \
            rsweep.baseline_opts(arch, shape)
        for multi in (False, True):
            opts = sweep.baseline_opts(arch, shape)
            assert sweep.cell_path("o", arch, shape, multi, opts) == \
                rsweep.cell_path("o", arch, shape, multi, opts)
    want = [(a, s) for a in list_archs() for s in SHAPES] + \
        [("pemsvm", s) for s in svm_cell.SVM_SHAPES]
    assert sweep.cells() == want


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))


def test_sweep_runs_two_cells_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--out",
           str(tmp_path), "--only", "svm_year,svm_alpha",
           "--single-pod-only"]
    first = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                           timeout=240)
    assert first.returncode == 0, first.stdout + first.stderr
    assert "sweep: 2 ok, 0 skipped, 0 failed of 2" in first.stdout
    for shape in ("svm_year", "svm_alpha"):
        rec = json.loads((tmp_path / f"pemsvm_{shape}_single.json")
                         .read_text())
        assert rec["ok"] and rec["mesh"] == "16x16"
    again = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                           timeout=120)
    assert "sweep: 2 ok" in again.stdout and "run=" in again.stdout


_RSS = textwrap.dedent("""
    import json


    def peak_kib():  # this process's peak RSS (ru_maxrss survives exec)
        with open("/proc/self/status") as f:
            return int(next(line for line in f
                            if line.startswith("VmHWM")).split()[1])


    import torch
    base = peak_kib()
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("deepseek-v2-236b", "decode_32k", False)
    peak = peak_kib()
    print(json.dumps({"ok": rec["ok"], "error": rec.get("error"),
                      "grew_kib": peak - base,
                      "arg": rec.get("memory", {}).get("argument_bytes")}))
""")


def test_largest_config_cheapest_cell_stays_small():
    out = subprocess.run([sys.executable, "-c", _RSS], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["ok"], rec["error"]
    assert rec["grew_kib"] * 1024 < 2 ** 30, rec
    assert rec["arg"] > 2 ** 30          # the cell's cache shards are real
