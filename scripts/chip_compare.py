#!/usr/bin/env python3
"""Compare this checkout's kernels with another checkout's, on the card.

    python3 scripts/chip_compare.py OTHER [--sass]

OTHER is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Needs one CUDA device and ``nvcc``; each tree builds
its own kernel library. Each step runs each tree's package in a process
of its own:

1. bits: the statistics, the Gram kernels and the featurizer of both
   trees, each on its own split plans, on the same inputs: how many
   outputs are bitwise equal, how many of the others are equal up to the
   sign of zero (and in how many entries), and how far the rest differ.
   fused_stats (six epilogues, with and without the Sigma weight mask, at
   float32 K % 4 != 0 and == 0, bfloat16, ragged last column blocks,
   N % 32 != 0; four chains; column windows), nystrom_fused_stats (six
   epilogues and their windows over several row chunks, phi width
   M % 4 != 0 and == 0), fused_estep (also at K = 1,537, 2,048, 2,049
   and 4,100, float32 and bfloat16, with each output's distance from
   OTHER's printed: max |d|, max |d| / max|v|, max |d| / |v|), syrk_tri
   and weighted_gram; nystrom_phi and nystrom_score (C = 1 and 3) at odd
   shapes (m % 32 != 0, P % 4 != 0, M = 129: a column tile holding only
   the bias column) over several row chunks, both kinds, float32 and
   bfloat16 X, mask and bias on and off, and on the featurizers of
   chip_smoke.py's phases 7, 8 and 10 (made once, by this tree, and read
   by both) over several chunks of their rows; the three Nystrom kernels
   (em_hinge for the statistic) at the cross-Gram's depths D = 1, 2, 3,
   31, 32, 33, 90 and 500, both kinds, float32 and bfloat16 X, over
   several chunks; and rbf_gram for each pair of operand types at those
   depths too;
2. times: chip_smoke.py's phase 3 kernel rows, projection rows and
   cross-Gram stage rows (this file's chip_smoke.py on each tree's
   package) in the order OTHER, this, this, OTHER, one line of kernel ms
   (and the projection's and the cross-Gram's torch.mm ms) for each run;
3. with --sass: the SASS of every kernel source in both trees, function
   by function (names compared without the copy policies' default
   template argument, NV = 1, without cross_tiles' row-major layout
   argument, and without the path hash of anonymous namespaces).
"""
import itertools
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


def featurizers(tree, out):
    """Rows and featurizers (landmarks, projection, sigma) of chip_smoke.py's
    phases 7, 8 and 10, made by ``tree``'s package and saved to ``out``:
    the bits step of both trees reads them."""
    _worker_env(tree)
    import torch
    import chip_smoke
    chip_smoke.torch = torch
    dev = torch.device("cuda", 0)
    Xc = chip_smoke.circles_data(1_000_000)[0]
    Xa = chip_smoke.alpha_data(300_000, 500)[0][:250_000]
    Xy = chip_smoke.year_split()[0]
    feats = {}
    for label, X, m, sigma, rows in (("phase 7", Xc, 1000, 0.7, 70_001),
                                     ("phase 8", Xa, 2048, math.sqrt(500),
                                      40_000),
                                     ("phase 10", Xy, 681, math.sqrt(90),
                                      50_000)):
        L, P = chip_smoke.featurizer(dev, X, m, sigma)
        feats[label] = (torch.from_numpy(X[:rows].copy()), L.cpu(), P.cpu(),
                        sigma)
    torch.save(feats, out)


def bits(tree, out, feats):
    """The kernels' outputs on fixed inputs, saved to ``out``."""
    _worker_env(tree)
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import (fused_estep, fused_stats, rbf_gram,
                                     ref, rng, syrk, weighted_gram)
    from repro_torch.kernels import nystrom_phi as nys
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

    def well(X, w):
        """rho = X w +- U[0.05, 2] (gamma >= ~0.05: the well-conditioned
        regime of chip_smoke.py, where b's distance from OTHER's is the
        summation order's and not 1/gamma's amplification)."""
        n = X.shape[0]
        off = 0.05 + 1.95 * torch.rand(n, generator=g, device=dev,
                                       dtype=torch.float64)
        return (X.double() @ w.double() + off * sign(n).double()).float()

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
        rho = well(X, w)
        for name, t in zip(("margin", "gamma", "b"),
                           fused_estep.fused_estep(X, rho, s, w)):
            res[f"fused_estep {tag} {name}"] = flat(t)
        wt = 1.0 / (0.05 + torch.rand(n, generator=g, device=dev))
        res[f"syrk_tri {tag}"] = flat(syrk.syrk_tri(X, wt))
        res[f"weighted_gram {tag}"] = flat(weighted_gram.weighted_gram(X, wt))
        del X
    # fused_estep at the K > 1536 route's widths: 16-byte loads (2,048),
    # one element a lane (1,537, 2,049), two column segments (4,100)
    for n, k in ((30001, 2048), (30001, 2049), (10007, 1537), (5003, 4100)):
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn(n, k, generator=g, device=dev).to(dt)
            w = torch.randn(k, generator=g, device=dev) / math.sqrt(k)
            beta = torch.randn(n, generator=g, device=dev)
            for name, t in zip(("margin", "gamma", "b"),
                               fused_estep.fused_estep(X, well(X, w), beta,
                                                       w)):
                res[f"fused_estep {n}x{k} {str(dt)[6:]} {name}"] = flat(t)
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
    scratch = nys.SCRATCH_WORDS
    for n, d, m, p in ((5003, 7, 45, 45), (3001, 3, 100, 99),
                       (2050, 5, 128, 128)):
        # several row chunks: a few hundred rows each
        nys.SCRATCH_WORDS = 384 * (m + 1)
        for dt in (torch.float32, torch.bfloat16):
            X = (torch.randn(n, d, generator=g, device=dev)
                 / math.sqrt(d)).to(dt)
            L = X[torch.randperm(n, generator=g, device=dev)[:m]].float()
            P = (0.2 * torch.randn(m, p, generator=g, device=dev)
                 / math.sqrt(m / 45))
            mask = (torch.rand(n, generator=g, device=dev) > 0.2).float()
            for kind in ("rbf", "linear"):
                for mk in (mask, None):
                    tag = (f"{n}x{d} m={m} P={p} {str(dt)[6:]} {kind} "
                           f"mask={mk is not None}")
                    for bias in (False, True):
                        res[f"nystrom_phi {tag} bias={bias}"] = flat(
                            nys.nystrom_phi(X, L, P, mk, sigma=1.3,
                                            kind=kind, add_bias=bias))
                    for C in (1, 3):
                        W = torch.randn(p + 1, C, generator=g, device=dev)
                        res[f"nystrom_score {tag} C={C}"] = flat(
                            nys.nystrom_score(X, L, P, W, mk, sigma=1.3,
                                              kind=kind, add_bias=True))
            del X
    # the cross-Gram's depths on both sides of its routes' threshold and of
    # a 32-deep stage, bfloat16 through the transposing pass, several chunks
    for d in (1, 2, 3, 31, 32, 33, 90, 500):
        n, m, p = 3001, 100, 99
        nys.SCRATCH_WORDS = 384 * max(m + 1, d)
        for dt in (torch.float32, torch.bfloat16):
            X = (torch.randn(n, d, generator=g, device=dev)
                 / math.sqrt(d)).to(dt)
            L = X[torch.randperm(n, generator=g, device=dev)[:m]].float()
            P = 0.2 * torch.randn(m, p, generator=g, device=dev)
            mask = (torch.rand(n, generator=g, device=dev) > 0.2).float()
            W = torch.randn(p + 1, 3, generator=g, device=dev)
            s = sign(n) * mask
            w = torch.randn(p + 1, generator=g, device=dev) / math.sqrt(p)
            for kind in ("rbf", "linear"):
                tag = f"{n}x{d} m={m} P={p} {str(dt)[6:]} {kind} depth"
                o = dict(sigma=1.3, kind=kind, add_bias=True)
                res[f"nystrom_phi {tag}"] = flat(nys.nystrom_phi(
                    X, L, P, mask, **o))
                res[f"nystrom_score {tag}"] = flat(nys.nystrom_score(
                    X, L, P, W, mask, **o))
                res[f"nystrom_fused_stats {tag} em_hinge"] = flat(
                    nys.nystrom_fused_stats(X, L, P, s, s, w, mask, **o,
                                            **kw("em_hinge", None, n)))
            del X
    nys.SCRATCH_WORDS = scratch
    for label, (X, L, P, sigma) in torch.load(feats).items():
        X, L, P = X.to(dev), L.to(dev), P.to(dev)
        tag = f"{label} featurizer {list(X.shape)} m={L.shape[0]}"
        res[f"nystrom_phi {tag}"] = flat(nys.nystrom_phi(
            X, L, P, sigma=sigma, add_bias=True))
        W = torch.randn(P.shape[1] + 1, 3, generator=g, device=dev)
        res[f"nystrom_score {tag} C=3"] = flat(nys.nystrom_score(
            X, L, P, W, sigma=sigma, add_bias=True))
        del X
    for (n1, n2, d), (ta, tb) in itertools.product(
            ((300, 257, 500), (1000, 1000, 2), (37, 45, 29), (301, 130, 1),
             (129, 255, 3), (300, 257, 31), (300, 257, 32), (300, 257, 33),
             (681, 681, 90), (2048, 131, 500)),
            ((torch.float32,) * 2, (torch.bfloat16, torch.float32),
             (torch.bfloat16,) * 2)):
        A = (torch.randn(n1, d, generator=g, device=dev)
             / math.sqrt(d)).to(ta)
        B = (torch.randn(n2, d, generator=g, device=dev)
             / math.sqrt(d)).to(tb)
        res[f"rbf_gram {n1}x{n2}x{d} {str(ta)[6:]},{str(tb)[6:]}"] = flat(
            rbf_gram.rbf_gram(A, B, sigma=0.7))
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
    line = {k: round(v["ms"], 4) for k, v in rows.items()}
    line.update({f"{k} torch.mm": round(v["library_ms"], 4)
                 for k, v in rows.items()
                 if k.startswith(("projection[", "cross["))})
    line["fused_estep[phase 8]"] = round(rows["fused_estep"]["phase8"]["ms"],
                                         4)
    print("TIMES " + json.dumps(line), flush=True)


def sass(tree, out):
    """{function: instructions} of every kernel source of ``tree``."""
    _worker_env(tree)
    from repro_torch.kernels import _build
    flags = [f for f in _build.FLAGS if f not in ("-Xptxas", "-v")]
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    srcs = sorted(_build.CSRC.glob("*.cu"))
    cubins = [Path(out).with_suffix(f".{src.name}.cubin") for src in srcs]
    procs = [subprocess.Popen([_build._nvcc(), *flags, "-cubin", "-o",
                               str(cubin), str(src)])
             for src, cubin in zip(srcs, cubins)]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("nvcc -cubin failed")
    fns = {}
    for src, cubin in zip(srcs, cubins):
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
                # cross_tiles' row-major layout argument dropped
                name = re.sub(r"(cross_tilesI\w+?Li\dE)Lb0E", r"\1", name)
                # an anonymous namespace's name hashes the source's path
                name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__",
                              name)
                cur = fns.setdefault(f"{src.name} {name}", [])
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
    """Per kernel: outputs bitwise equal; of the others, those equal up to
    the sign of zero (and in how many entries the sign differs); the
    rest's largest difference over their largest value."""
    import torch
    x, y = torch.load(a), torch.load(b)
    groups = {}
    for k in x:
        g = groups.setdefault(k.split()[0], dict(n=0, bits=0, zero=0,
                                                 entries=0, worst=0.0,
                                                 differ=[]))
        g["n"] += 1
        xb, yb = x[k].view(torch.int32), y[k].view(torch.int32)
        if torch.equal(xb, yb):
            g["bits"] += 1
        elif bool(torch.all(x[k] == y[k])):
            g["zero"] += 1
            g["entries"] += int((xb != yb).sum())
        else:
            g["worst"] = max(g["worst"], (
                (x[k].double() - y[k].double()).abs().max()
                / x[k].double().abs().max().clamp_min(1e-30)).item())
            g["differ"].append(k)
    for k in [k for k in x if k.startswith("fused_estep")]:
        d = (x[k].double() - y[k].double()).abs()
        v = x[k].double().abs()
        print(f"distance, {label}: {k}: max |d| {d.max().item():.3e}, max "
              f"|d| / max|v| {(d.max() / v.max().clamp_min(1e-30)).item():.3e}"
              f", max |d| / |v| {(d / v.clamp_min(1e-30)).max().item():.3e}")
    for name, g in groups.items():
        print(f"bits, {label}: {name}: {g['bits']} of {g['n']} outputs "
              f"bitwise equal, {g['zero']} more equal up to the sign of zero "
              f"({g['entries']} entries), {len(g['differ'])} differ (max |d| "
              f"/ max|v| {g['worst']:.3e})")
        for k in g["differ"][:4]:
            print(f"  differs: {k}")


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        step, tree, *rest = sys.argv[2:]
        {"featurizers": featurizers, "bits": bits, "times": times,
         "sass": sass}[step](tree, *rest)
        return
    other = str(Path(sys.argv[1]).resolve())
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = Path(tmp)
        feats = str(t / "feats.pt")
        _run("--worker", "featurizers", str(ROOT), feats)
        _run("--worker", "bits", other, str(t / "other.pt"), feats)
        _run("--worker", "bits", str(ROOT), str(t / "this.pt"), feats)
        compare_bits(t / "other.pt", t / "this.pt", "this tree against OTHER")
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
                same = ("identical" if a.get(name) == b.get(name) else
                        "only in OTHER" if name not in b else
                        "only in this tree" if name not in a else
                        "DIFFERENT")
                print(f"sass {name}: {len(a.get(name, []))} / "
                      f"{len(b.get(name, []))} instructions, {same}")


if __name__ == "__main__":
    main()
