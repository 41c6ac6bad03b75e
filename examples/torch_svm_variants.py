"""All six option axes of the paper (Sec 4.2) on their matching tasks,
with ``repro_torch``:

  LIN-{EM,MC}-CLS   binary classification     (dna-like)
  LIN-EM-SVR        support vector regression (year protocol, eps=0.3)
  LIN-MC-MLT        Crammer-Singer multiclass (mnist8m protocol, C=0.04)
  KRN-{EM,MC}-CLS   RBF kernel                (not linearly separable)

    PYTHONPATH=src python examples/torch_svm_variants.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import PEMSVM, SVMConfig, lam_from_C  # noqa: E402
from repro_torch.data import (  # noqa: E402
    make_circles, make_dna_like, make_mnist8m_like, make_year_like)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    dev = ap.parse_args().device

    X, y = make_dna_like(20_000, 200)
    for algo in ("EM", "MC"):
        svm = PEMSVM(SVMConfig.from_options(
            f"LIN-{algo}-CLS", lam=lam_from_C(1e-5), max_iters=60),
            device=dev)
        r = svm.fit(X, y)
        print(f"LIN-{algo}-CLS  acc={svm.score(X, y):.4f} "
              f"iters={r.n_iters}")

    Xr, yr = make_year_like(20_000, 90)
    svr = PEMSVM(SVMConfig.from_options(
        "LIN-EM-SVR", lam=lam_from_C(0.01), eps_ins=0.3, max_iters=60),
        device=dev)
    svr.fit(Xr, yr)
    print(f"LIN-EM-SVR  rmse={svr.rmse(Xr, yr):.4f} (paper: 0.90 on year)")

    Xm, lm = make_mnist8m_like(10_000, 128, 10)
    mlt = PEMSVM(SVMConfig.from_options(
        "LIN-MC-MLT", num_classes=10, lam=lam_from_C(0.04), max_iters=35,
        min_iters=25), device=dev)
    mlt.fit(Xm, lm)
    print(f"LIN-MC-MLT  acc={mlt.score(Xm, lm):.4f}")

    Xc, yc = make_circles(600)
    for algo in ("EM", "MC"):
        k = PEMSVM(SVMConfig.from_options(
            f"KRN-{algo}-CLS", lam=lam_from_C(1.0), sigma=0.7,
            max_iters=50), device=dev)
        k.fit(Xc, yc)
        print(f"KRN-{algo}-CLS  acc={k.score(Xc, yc):.4f} "
              f"(linear would be ~0.5)")


if __name__ == "__main__":
    main()
