"""Run the dry-run sweep: every (arch x shape) cell on both meshes, plus
the paper's PEMSVM cells (``repro/launch/sweep.py`` in PyTorch). Each
cell runs in a subprocess of ``repro_torch.launch.dryrun`` under a
timeout, so that one cell's failure or memory does not take the sweep
down, and is cached by its output JSON, so the sweep is resumable.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--out runs/dryrun]
        [--force] [--only yi-34b,...] [--single-pod-only] [--skip-svm]

Baseline option policy (recorded in each JSON), the reference's:
  * train cells: microbatches=4, and 8 for the two biggest-activation
    archs (jamba-v0.1-52b, deepseek-v2-236b).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import SHAPES, list_archs
from repro_torch.launch.svm_cell import SVM_SHAPES


def baseline_opts(arch: str, shape_name: str) -> list[str]:
    if arch.startswith("pemsvm"):
        return []
    opts = []
    if SHAPES[shape_name].kind == "train":
        mb = 8 if arch in ("jamba-v0.1-52b", "deepseek-v2-236b") else 4
        opts.append(f"microbatches={mb}")
    return opts


def cell_path(out: str, arch: str, shape: str, multi: bool,
              opts: list[str]) -> str:
    tag = "multi" if multi else "single"
    suffix = ("_" + "_".join(o.replace("=", "-") for o in sorted(opts))
              if opts else "")
    return os.path.join(out, f"{arch}_{shape}_{tag}{suffix}.json")


def cells(skip_svm: bool = False, only: str = "") -> list[tuple[str, str]]:
    """(arch, shape) of the sweep: every arch x shape, then the pemsvm
    cells; ``only`` (comma-separated) keeps those naming an arch or a
    shape in it."""
    out = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    if not skip_svm:
        out += [("pemsvm", shape) for shape in SVM_SHAPES]
    if only:
        keep = set(only.split(","))
        out = [(a, s) for a, s in out if a in keep or s in keep]
    return out


def run_one(arch: str, shape: str, multi: bool, out: str,
            opts: list[str], timeout: int = 1800) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", out]
    if multi:
        cmd.append("--multi-pod")
    for o in opts:
        cmd += ["--opt", o]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([src, env.get("PYTHONPATH", "")])
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=timeout)
        tail = (p.stderr or p.stdout)[-1500:]
    except subprocess.TimeoutExpired:
        tail = f"timed out after {timeout} s"
    path = cell_path(out, arch, shape, multi, opts)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"arch": arch, "shape": shape, "ok": False, "error": tail,
            "total_s": round(time.time() - t0, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--skip-svm", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    meshes = [False] if args.single_pod_only else [False, True]
    total = ok = skipped = failed = 0
    t_start = time.time()
    for arch, shape in cells(args.skip_svm, args.only):
        for multi in meshes:
            opts = baseline_opts(arch, shape)
            path = cell_path(args.out, arch, shape, multi, opts)
            total += 1
            if os.path.exists(path) and not args.force:
                with open(path) as f:
                    rec = json.load(f)
            else:
                rec = run_one(arch, shape, multi, args.out, opts)
            tag = "multi" if multi else "single"
            if rec.get("skipped"):
                skipped += 1
                print(f"[{total:3d}] SKIP {arch} {shape} {tag}: "
                      f"{rec['reason'][:60]}", flush=True)
            elif rec.get("ok"):
                ok += 1
                fits = rec["memory"]["fits_hbm"]
                print(f"[{total:3d}] OK   {arch} {shape} {tag} "
                      f"run={rec.get('run_s', '?')}s "
                      f"dominant={rec['terms']['dominant']} "
                      f"fits={'Y' if fits else 'N'} "
                      f"ratio={rec['useful_flops_ratio']:.3f}", flush=True)
            else:
                failed += 1
                print(f"[{total:3d}] FAIL {arch} {shape} {tag}: "
                      f"{rec.get('error', '')[:120]}", flush=True)
    print(f"\nsweep: {ok} ok, {skipped} skipped, {failed} failed "
          f"of {total} in {(time.time() - t_start) / 60:.1f} min")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
