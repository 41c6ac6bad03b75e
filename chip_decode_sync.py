#!/usr/bin/env python3
"""smollm-135m's decode step with and without a host-to-device copy per
layer, on one GPU.

    python3 chip_decode_sync.py [--rounds 4] [--steps 32]

Needs one CUDA device; exits non-zero without one. ``decode_attn`` builds
its cache mask from the Python int ``valid_len`` on the device. The other
variant hands it ``torch.as_tensor(valid_len, device=...)`` instead, a
copy from pageable host memory that PyTorch follows with a stream
synchronize, once in each of the 30 layers. The model and the prompts are
``chip_smoke.py`` phase 18 (a)'s: smollm-135m at full size from
``Model.init(0)``, 8 prompts of 512 tokens of ``make_lm_tokens(seed=1)``,
cache 576, bfloat16. Each round times ``--steps`` greedy decode steps of
each variant, in the order copy, int, int, copy; the line per variant is
the median step over all its rounds and the tokens of both variants are
checked equal.
"""
import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_decode_sync: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_tokens
    from repro_torch.models import attention, build_model
    from repro_torch.serving import make_decode_step, make_prefill_step
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = get_config("smollm-135m")
    model = build_model(cfg, dev)
    model.init(0)
    batch, prompt, cache = 8, 512, 576
    toks = make_lm_tokens(batch * prompt, cfg.vocab, seed=1
                          ).reshape(batch, prompt)
    prefill = make_prefill_step(model, cache)
    decode = make_decode_step(model)
    on_device = attention.decode_attn

    def with_copy(q, k, v, valid_len):
        return on_device(q, k, v, torch.as_tensor(valid_len,
                                                  device=q.device))

    def run(copy: bool):
        attention.decode_attn = with_copy if copy else on_device
        try:
            tok, caches = prefill({"tokens": toks})
            torch.cuda.synchronize()
            times, out = [], []
            for i in range(args.steps):
                t0 = time.perf_counter()
                tok, _, caches = decode(tok[:, None], prompt + i, caches)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                out.append(tok)
            return times, torch.stack(out)
        finally:
            attention.decode_attn = on_device

    run(False)                                      # warm-up
    got = {True: [], False: []}
    toks_of = {}
    for _ in range(args.rounds):
        for copy in (True, False, False, True):
            times, t = run(copy)
            got[copy] += times
            toks_of[copy] = t
    same = torch.equal(toks_of[True], toks_of[False])
    print(f"card: {card}")
    for copy, label in ((True, "a host copy a layer"),
                        (False, "mask from the int")):
        print(f"decode step, {label}: median "
              f"{statistics.median(got[copy]) * 1e3:.3f} ms of "
              f"{len(got[copy])} steps (min "
              f"{min(got[copy]) * 1e3:.3f})")
    print(f"tokens equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
