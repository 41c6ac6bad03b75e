"""Beyond-paper example on the port: the paper asks (Sec 4.3) whether
PSVM's sqrt(N) kernel approximation can compose with the sampling SVM —
NystromSVM is that composition. Kernel accuracy at linear-solver cost.

    PYTHONPATH=src python examples/torch_nystrom_kernel_svm.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import NystromSVM, SVMConfig  # noqa: E402
from repro_torch.data import make_circles  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    dev = ap.parse_args().device
    X, y = make_circles(10_000)
    t0 = time.time()
    svm = NystromSVM(SVMConfig.from_options(
        "KRN-EM-CLS", lam=0.1, sigma=0.7, max_iters=60),
        device=dev)  # m = sqrt(N) = 100
    res = svm.fit(X, y)
    print(f"N=10,000 kernel SVM via m=100 landmarks: "
          f"acc={svm.score(X, y):.4f} iters={res.n_iters} "
          f"({time.time() - t0:.1f}s; exact KRN is O(N^3) per iteration)")


if __name__ == "__main__":
    main()
