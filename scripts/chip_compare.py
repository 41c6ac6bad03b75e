#!/usr/bin/env python3
"""Compare this checkout's kernels with another checkout's, on the card.

    python3 scripts/chip_compare.py OTHER [--sass]

OTHER is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Needs one CUDA device and ``nvcc``; each tree builds
its own kernel library. Each step runs each tree's package in a process
of its own:

1. bits: the statistics and the Gram kernels of both trees on the same
   inputs, and how many outputs are bitwise equal: fused_stats (six
   epilogues, with and without the Sigma weight mask, at float32 K % 4 !=
   0 and == 0, bfloat16, ragged last column blocks, N % 32 != 0; four
   chains; column windows), nystrom_fused_stats (six epilogues and their
   windows over several row chunks, phi width M % 4 != 0 and == 0),
   fused_estep, syrk_tri and weighted_gram. This tree runs twice: on its
   own split plans, and on the plans the kernels ran before the Gram
   engine (``_build.tile_plan`` and chip_smoke.py's ``old_stats_plan``
   patched in), where a change that keeps the arithmetic must be bitwise
   the other tree;
2. times: chip_smoke.py's phase 3 kernel rows (this file's chip_smoke.py
   on each tree's package) in the order OTHER, this, this, OTHER, one line
   of kernel ms for each run;
3. with --sass: the SASS of syrk.cu's and weighted_gram.cu's kernels in
   both trees, function by function (names compared without the copy
   policies' default template argument, NV = 1, and the path hash of
   anonymous namespaces).
"""
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _worker_env(tree):
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            Path(tree).resolve()):
        raise SystemExit(f"imported {repro_torch.__file__}, not {tree}'s")


def old_plans():
    """Patch in the split plans the statistics ran on before the Gram
    engine (this tree only; the other tree keeps its own)."""
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import nystrom_phi as nys
    dev = torch.device("cuda", 0)
    if hasattr(_build, "stat_plan"):
        _build.stat_plan = lambda N, K, C, sms: _build.tile_plan(N, K, dev)
        nys.stats_plan = chip_smoke.old_stats_plan


def bits(tree, out, plans):
    """The kernels' outputs on fixed inputs, saved to ``out``."""
    _worker_env(tree)
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import (fused_estep, fused_stats, ref, rng,
                                     syrk, weighted_gram)
    from repro_torch.kernels import nystrom_phi as nys
    if plans == "old":
        old_plans()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    seed = rng.pack_seed(prng.fold_in(prng.PRNGKey(7), 3), 11, 1).to(dev)
    epis = [("em_hinge", None), ("mc_hinge", "noise"), ("mc_hinge", "seed"),
            ("em_svr", None), ("mc_svr", "noise"), ("mc_svr", "seed")]
    res = {}

    def sign(n):
        return torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                           -1.0, 1.0)

    def kw(epi, src, n):
        d = dict(epilogue=epi, eps=1e-6, eps_ins=0.3 if "svr" in epi else 0.0)
        if src == "noise":
            d["noise"] = ref.seed_noise(seed, n, 1, epi)
        elif src == "seed":
            d["seed"] = seed
        return d

    def flat(r):
        r = r if isinstance(r, tuple) else (r,)
        return torch.cat([t.reshape(-1).float() for t in r]).cpu()

    for n, k, dt in ((30000, 501, torch.float32), (30000, 500, torch.float32),
                     (30001, 301, torch.bfloat16),
                     (5003, 129, torch.float32),
                     (3001, 257, torch.bfloat16),
                     (10007, 91, torch.float32)):
        X = torch.randn(n, k, generator=g, device=dev).to(dt)
        w = torch.randn(k, generator=g, device=dev) / math.sqrt(k)
        y = (X.double() @ w.double() + 0.5 * torch.randn(
            n, generator=g, device=dev, dtype=torch.float64)).float()
        s = sign(n)
        wm = (torch.rand(n, generator=g, device=dev) > 0.2).float()
        tag = f"{n}x{k} {str(dt)[6:]}"
        for epi, src in epis:
            rho, beta = (y, torch.zeros_like(y)) if "svr" in epi else (s, s)
            for mask in (wm, None):
                res[f"fused_stats {tag} {epi} {src} mask={mask is not None}"] \
                    = flat(fused_stats.fused_stats(X, rho, beta, w, mask,
                                                   **kw(epi, src, n)))
            for win in ((0, k // 2), (k // 3, k // 3), (k - 1, 1)):
                res[f"fused_stats {tag} {epi} {src} window {win}"] = flat(
                    fused_stats.fused_stats(X, rho, beta, w, wm,
                                            col_window=win,
                                            **kw(epi, src, n)))
        wc = torch.stack([w * (1.0 + 0.25 * c) for c in range(4)], 1)
        for epi in ("mc_hinge", "mc_svr"):
            rho, beta = (y, torch.zeros_like(y)) if "svr" in epi else (s, s)
            res[f"fused_stats {tag} {epi} C=4"] = flat(
                fused_stats.fused_stats(X, rho, beta, wc.contiguous(), wm,
                                        seed=seed, epilogue=epi, eps=1e-6,
                                        eps_ins=0.3 if "svr" in epi else 0))
        res[f"fused_estep {tag}"] = flat(fused_estep.fused_estep(X, s, s, w))
        wt = 1.0 / (0.05 + torch.rand(n, generator=g, device=dev))
        res[f"syrk_tri {tag}"] = flat(syrk.syrk_tri(X, wt))
        res[f"weighted_gram {tag}"] = flat(weighted_gram.weighted_gram(X, wt))
        del X
    for n, d, m, dt in ((70001, 16, 1000, torch.float32),
                        (70001, 16, 1023, torch.float32),
                        (20011, 5, 681, torch.bfloat16)):
        X = torch.randn(n, d, generator=g, device=dev).to(dt)
        L = X[:m].float().contiguous()
        P = torch.randn(m, m, generator=g, device=dev) / math.sqrt(m)
        M = m + 1
        w = torch.randn(M, generator=g, device=dev) / math.sqrt(M)
        mask = (torch.rand(n, generator=g, device=dev) > 0.1).float()
        s = sign(n) * mask
        y = torch.randn(n, generator=g, device=dev) * mask
        o = dict(sigma=3.0, kind="rbf", add_bias=True)
        for epi, src in epis:
            rho, beta = (y, torch.zeros_like(y)) if "svr" in epi else (s, s)
            for win in (None, (0, M // 2), (M // 2, M - M // 2), (7, 130)):
                res[f"nystrom_fused_stats {n}x{d} m={m} {epi} {src} "
                    f"window {win}"] = flat(nys.nystrom_fused_stats(
                        X, L, P, rho, beta, w, mask, col_window=win, **o,
                        **kw(epi, src, n)))
        del X
    torch.cuda.synchronize()
    torch.save(res, out)


def times(tree):
    """chip_smoke.py's phase 3 rows on ``tree``'s package, as JSON."""
    _worker_env(tree)
    import torch
    import chip_smoke
    chip_smoke.torch = torch
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows = chip_smoke.phase_kernels(dev)
    rows.update(chip_smoke.phase_svr_kernels(dev)[0])
    rows.update(chip_smoke.phase_nystrom_kernels(dev))
    rows.update(chip_smoke.phase_window_kernels(dev))
    print("TIMES " + json.dumps({k: round(v["ms"], 4)
                                 for k, v in rows.items()}), flush=True)


def sass(tree, out):
    """{function: instructions} of syrk.cu and weighted_gram.cu."""
    _worker_env(tree)
    from repro_torch.kernels import _build
    flags = [f for f in _build.FLAGS if f not in ("-Xptxas", "-v")]
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    fns = {}
    for src in ("syrk.cu", "weighted_gram.cu"):
        cubin = Path(out).with_suffix(f".{src}.cubin")
        subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                        str(_build.CSRC / src)], check=True)
        text = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        cur = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                # the copy policies' default NV = 1 dropped from the name
                name = re.sub(r"(CopyF32ILi\d+E)Li1EE", r"\1E", m.group(1))
                name = name.replace("CopyBf16ILi1EE", "CopyBf16")
                # an anonymous namespace's name hashes the source's path
                name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__",
                              name)
                cur = fns.setdefault(f"{src} {name}", [])
            elif cur is not None and re.search(r"/\*[0-9a-f]{4}\*/", line):
                cur.append(re.sub(r"/\*[0-9a-f]{4}\*/", "", line)
                           .split(";")[0].strip())
    Path(out).write_text(json.dumps(fns))


def _run(*args):
    p = subprocess.run([sys.executable, __file__, *args], cwd=ROOT,
                       capture_output=True, text=True)
    if p.returncode != 0:
        print(p.stdout[-4000:], p.stderr[-4000:])
        raise SystemExit(f"chip_compare {args[:2]} failed")
    return p.stdout


def compare_bits(a, b, label):
    import torch
    x, y = torch.load(a), torch.load(b)
    same = [k for k in x if torch.equal(x[k], y[k])]
    worst = max((((x[k].double() - y[k].double()).abs().max()
                  / x[k].double().abs().max().clamp_min(1e-30)).item()
                 for k in x if k not in same), default=0.0)
    print(f"bits, {label}: {len(same)} of {len(x)} outputs bitwise equal; "
          f"the others within max |d| / max|v| {worst:.3e}")
    for k in [k for k in x if k not in same][:8]:
        print(f"  differs: {k}")


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        step, tree, *rest = sys.argv[2:]
        {"bits": bits, "times": times, "sass": sass}[step](tree, *rest)
        return
    other = str(Path(sys.argv[1]).resolve())
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = Path(tmp)
        _run("--worker", "bits", other, str(t / "other.pt"), "own")
        _run("--worker", "bits", str(ROOT), str(t / "old.pt"), "old")
        _run("--worker", "bits", str(ROOT), str(t / "own.pt"), "own")
        compare_bits(t / "other.pt", t / "old.pt",
                     "this tree on the staged pass's plans against OTHER")
        compare_bits(t / "other.pt", t / "own.pt",
                     "this tree on its own plans against OTHER")
        for tree, label in ((other, "OTHER"), (str(ROOT), "this"),
                            (str(ROOT), "this"), (other, "OTHER")):
            line = [x for x in _run("--worker", "times", tree).splitlines()
                    if x.startswith("TIMES ")][-1]
            print(f"times, {label}: {line[6:]}", flush=True)
        if "--sass" in sys.argv:
            _run("--worker", "sass", other, str(t / "other.json"))
            _run("--worker", "sass", str(ROOT), str(t / "this.json"))
            a = json.loads((t / "other.json").read_text())
            b = json.loads((t / "this.json").read_text())
            for name in sorted(set(a) | set(b)):
                same = a.get(name) == b.get(name)
                print(f"sass {name}: {len(a.get(name, []))} / "
                      f"{len(b.get(name, []))} instructions, "
                      f"{'identical' if same else 'DIFFERENT'}")


if __name__ == "__main__":
    main()
