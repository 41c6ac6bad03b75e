"""Composite max-margin model on the port (paper Sec 1 / DESIGN.md §4): a
frozen LM backbone + PEMSVM head — the MedLDA-style use case the paper
motivates, with any assigned architecture as the feature extractor.

    PYTHONPATH=src python examples/torch_lm_feature_svm.py \
        [--arch smollm-135m] [--device cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import MaxMarginHead, SVMConfig, mean_pool  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args()

    cfg = dataclasses.replace(
        get_config(args.arch), n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=256)
    model = build_model(cfg, device=args.device, q_chunk=32, kv_chunk=32)
    model.init(0)

    # synthetic "document classification": token-range signal
    rng = np.random.default_rng(0)
    N, S = 1200, 32
    cls = rng.random(N) > 0.5
    toks = np.where(cls[:, None], rng.integers(0, 96, (N, S)),
                    rng.integers(160, 256, (N, S))).astype(np.int32)
    y = np.where(cls, 1.0, -1.0)

    def feature_fn(tokens):
        return mean_pool(model.hidden_seq({"tokens": tokens}).float())

    head = MaxMarginHead(SVMConfig(lam=0.1, max_iters=60), feature_fn,
                         device=model.device)
    res = head.fit(toks[:1000], y[:1000])
    print(f"backbone={args.arch} (frozen, reduced)  head=LIN-EM-CLS  "
          f"device={head.device}")
    print(f"converged={res.converged} iters={res.n_iters}")
    print(f"train acc={head.score(toks[:1000], y[:1000]):.4f}  "
          f"test acc={head.score(toks[1000:], y[1000:]):.4f}")


if __name__ == "__main__":
    main()
