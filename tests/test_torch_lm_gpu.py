"""The dense LM serving path and the max-margin head on the card.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_gpu.py

This file imports no JAX: the card is held against the port's own CPU
forward, which tests/test_torch_lm.py holds against the reference.

* A reduced smollm-135m (4 layers, d 128, 4 / 2 heads) in float32, weights
  drawn on the card from seed 0 and copied to a CPU model: hidden states,
  logits, the prefill caches and a decode step's logits within 1e-4 of
  max|CPU| (the ULP sources of test_torch_lm.py plus cuBLAS's summation
  order; TF32 is off).
* Greedy generation in bfloat16 twice on the card: bitwise equal tokens.
* The head on the card: ``fused_stats`` launched once a step of the
  kernel fit, never by the plain fit (backend="ref") on the same
  features; weights within 1e-3 of max|w| after two iterations, and at
  convergence iterations within 3 and accuracy within 0.01.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import MaxMarginHead, PEMSVM, SVMConfig, mean_pool
from repro_torch.kernels import fused_stats
from repro_torch.models import build_model
from repro_torch.serving import generate

pytestmark = pytest.mark.gpu

BAND = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(**kw):
    return dataclasses.replace(
        get_config("smollm-135m"), n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, **kw)


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def test_card_forward_matches_cpu_in_float32(cuda):
    cfg = _cfg(dtype="float32")
    card = build_model(cfg, cuda, q_chunk=32, kv_chunk=32)
    card.init(0)
    cpu = build_model(cfg, "cpu", q_chunk=32, kv_chunk=32)
    cpu.load_params(card.params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 97)
                                             ).astype(np.int32)
    batch = {"tokens": toks[:, :96]}
    assert _rel(card.hidden_seq(batch), cpu.hidden_seq(batch)) <= BAND
    assert _rel(card.logits_seq(batch), cpu.logits_seq(batch)) <= BAND
    lg, cc = card.prefill(batch, 100)
    lc, cp = cpu.prefill(batch, 100)
    assert _rel(lg, lc) <= BAND
    for i in range(2):
        assert _rel(cc["pos0"][i], cp["pos0"][i]) <= BAND
    dg, _ = card.decode(toks[:, 96:], 96, cc)
    dc, _ = cpu.decode(toks[:, 96:], 96, cp)
    assert _rel(dg, dc) <= BAND


def test_greedy_generation_is_deterministic(cuda):
    model = build_model(_cfg(), cuda, q_chunk=16, kv_chunk=16)
    model.init(1)
    toks = np.random.default_rng(1).integers(0, 512, (4, 48)
                                             ).astype(np.int32)
    a = generate(model, {"tokens": toks}, steps=12, cache_len=64)
    b = generate(model, {"tokens": toks}, steps=12, cache_len=64)
    assert a.shape == (4, 12) and a.dtype == torch.int32
    assert a.device.type == "cpu" and torch.equal(a, b)


def test_head_kernel_fit_against_plain_fit(cuda):
    model = build_model(_cfg(), cuda, q_chunk=32, kv_chunk=32)
    model.init(2)
    rng = np.random.default_rng(2)
    n, s, V = 2048, 32, 512
    cls = rng.random(n) > 0.5
    toks = np.where(cls[:, None], rng.integers(0, 3 * V // 8, (n, s)),
                    rng.integers(5 * V // 8, V, (n, s))).astype(np.int32)
    y = np.where(cls, 1.0, -1.0)

    def feature_fn(t):
        return mean_pool(model.hidden_seq({"tokens": t}).float())

    for kw in (dict(max_iters=2, min_iters=2), dict(max_iters=60)):
        head = MaxMarginHead(SVMConfig(lam=0.1, **kw), feature_fn,
                             device=cuda)
        X = head.extract(toks)
        assert X.shape == (n, 128) and np.isfinite(X).all()
        fused_stats.zero_launches()
        res = head.fit(toks, y)
        launched = fused_stats.LAUNCHES["em_hinge"]
        cfg = head.svm.config
        steps = min(cfg.max_iters, -(-res.n_iters // cfg.scan_chunk)
                    * cfg.scan_chunk)
        assert launched == steps, (launched, res.n_iters)
        plain = PEMSVM(dataclasses.replace(cfg, backend="ref"), device=cuda)
        rp = plain.fit(X, y)
        assert fused_stats.LAUNCHES["em_hinge"] == launched
        if kw.get("min_iters") == 2:
            w, wp = res.weights.astype(np.float64), rp.weights
            assert np.abs(w - wp).max() <= 1e-3 * np.abs(wp).max()
        else:
            assert abs(res.n_iters - rp.n_iters) <= 3
            assert abs(head.score(toks, y) - plain.score(X, y)) <= 0.01
