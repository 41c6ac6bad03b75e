"""Serving drivers.

LM mode (default): build a model (dense, MoE, MLA, the Mamba hybrid,
xLSTM, or the encoder-decoder, fed zero frames as the reference's demo
feeds them; the VLM is refused, as ``launch.train`` says) from its
config (``--preset tiny`` is the reference's reduction, ``full`` the
published widths), draw its weights from ``--seed``, prefill a batch of
prompts made by ``make_lm_tokens`` and decode ``--steps`` tokens,
greedily or at ``--temp``:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch smollm-135m --preset tiny --batch 4 --prompt-len 32 --steps 16

SVM mode: fit a few tenant models, export them, page them through a
shared score cell and drive the threaded continuous-batching loop, then
check every tenant's served scores bitwise against its
``decision_function``:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode svm \\
        --tenants 6 --requests 200 --family nystrom

Runs on ``cuda:0`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time


def main_lm(args) -> bool:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_tokens
    from repro_torch.models import build_model
    from repro_torch.serving import generate

    from .train import preset, refuse_vlm

    cfg = preset(get_config(args.arch), args.preset)
    refuse_vlm(cfg, "serving demo")
    model = build_model(cfg, args.device, q_chunk=min(512, args.prompt_len),
                        kv_chunk=min(512, args.prompt_len))
    model.init(args.seed)
    tokens = make_lm_tokens(args.batch * args.prompt_len, cfg.vocab,
                            seed=args.seed + 1).reshape(args.batch,
                                                        args.prompt_len)
    batch = {"tokens": tokens}
    if cfg.enc_dec:
        batch["frames"] = torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                                      device=model.device)
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    out = generate(model, batch, steps=args.steps,
                   cache_len=args.prompt_len + args.steps, temp=args.temp,
                   seed=args.seed)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} ({args.preset}, {model.num_params():,} parameters) "
          f"on {model.device}")
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")
    print("first sequences:", out[:2].tolist())
    return tuple(out.shape) == (args.batch, args.steps)


def main_svm(args) -> bool:
    import numpy as np

    from repro_torch.core import NystromSVM, PEMSVM, SVMConfig
    from repro_torch.serving import ServeLoop, WeightPager

    rng = np.random.default_rng(args.seed)
    n, d = 4_000, 32
    X = rng.normal(size=(n, d)).astype(np.float32)

    pager = WeightPager(max_resident=args.resident, device=args.device)
    oracles = {}
    for t in range(args.tenants):
        w = rng.normal(size=d)
        y = np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)
        if args.family == "nystrom":
            model = NystromSVM(
                SVMConfig(formulation="KRN", sigma=3.0, lam=0.1,
                          max_iters=15, min_iters=5), n_landmarks=48,
                device=args.device)
        else:
            model = PEMSVM(SVMConfig(max_iters=15, min_iters=5),
                           device=args.device)
        model.fit(X, y)
        name = f"tenant{t}"
        pager.register(model.export_servable(name=name))
        oracles[name] = model.decision_function(X[:256])

    loop = ServeLoop(pager).start()
    t0 = time.perf_counter()
    futs = []
    for i in range(args.requests):
        nr = int(rng.integers(1, 97))
        j = int(rng.integers(0, n - nr + 1))
        futs.append(loop.submit(f"tenant{i % args.tenants}", X[j:j + nr]))
    rows = sum(f.result(timeout=60).shape[0] for f in futs)
    dt = time.perf_counter() - t0
    loop.stop()

    q = loop.latency_quantiles()
    ok = all(
        np.array_equal(pager.scorer(name).score(X[:256])[:, 0], oracle)
        for name, oracle in oracles.items())
    print(f"served {loop.n_requests} requests / {rows} rows in {dt:.2f}s "
          f"({rows / dt:.0f} rows/s) over {loop.n_batches} batches")
    print(f"latency p50={q['p50_ms']:.2f}ms p99={q['p99_ms']:.2f}ms  "
          f"pager hits={pager.hits} misses={pager.misses} "
          f"evictions={pager.evictions} "
          f"resident={pager.resident_bytes}B")
    print(f"bitwise parity vs decision_function across all tenants: {ok}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lm", choices=["lm", "svm"])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--resident", type=int, default=4)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--family", default="linear",
                    choices=["linear", "nystrom"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)
    ok = main_lm(args) if args.mode == "lm" else main_svm(args)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
