"""Quickstart on the port: train the paper's parallel sampling SVM
(PEMSVM) with ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Fits LIN-EM-CLS on a synthetic binary problem with the paper's protocol
(objective-change stopping, gamma clamping), reports accuracy and the
convergence trace, then the MCMC flavour. Runs on ``cuda:0`` unless
given ``--device``; pass a ``DeviceMesh`` to PEMSVM(...) to engage the
Fig.-1 map-reduce over its ranks."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import PEMSVM, SVMConfig, lam_from_C  # noqa: E402
from repro_torch.data import make_blobs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args()
    X, y = make_blobs(n=20_000, k=100, seed=0)
    Xtr, ytr, Xte, yte = X[:16_000], y[:16_000], X[16_000:], y[16_000:]

    config = SVMConfig.from_options("LIN-EM-CLS", lam=lam_from_C(1.0),
                                    max_iters=100)
    svm = PEMSVM(config, device=args.device)
    result = svm.fit(Xtr, ytr)

    print(f"device        : {svm.device}")
    print(f"options       : {config.options}")
    print(f"converged     : {result.converged} "
          f"({result.n_iters} iterations — paper reports 40-60 for EM)")
    print(f"train objective: {result.objective[0]:.1f} -> "
          f"{result.objective[-1]:.1f}")
    print(f"test accuracy : {svm.score(Xte, yte):.4f}")

    # MCMC flavor: posterior-averaged weights (paper Sec 5.13)
    mc = PEMSVM(SVMConfig.from_options("LIN-MC-CLS", lam=lam_from_C(1.0),
                                       max_iters=60, burnin=10),
                device=args.device)
    mc.fit(Xtr, ytr)
    print(f"MC accuracy   : {mc.score(Xte, yte):.4f} (averaged samples)")


if __name__ == "__main__":
    main()
