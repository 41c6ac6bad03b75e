"""The LM training path on the card.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_train_gpu.py

This file imports no JAX: the card is held against the port's own CPU
train step, which tests/test_torch_train.py holds against the reference.

* One train step of reduced smollm-135m and granite-moe-1b-a400m in
  float32, weights drawn on the card and copied to a CPU model: the loss
  within 1e-4 relative, every gradient leaf within 1e-4 of max|g| and the
  parameters after the update with rtol 1e-3, atol 1.5 x 2 lr (the CPU
  bands of tests/test_torch_train.py; TF32 is off).
* The train step is repeatable on the card: twice from one state, on a
  batch whose token ids repeat hundreds of times (the embedding's
  backward sums them) and whose MoE routes fill the experts' queues,
  the gradients and the new state are bitwise equal.
* Kill and resume on the card: 6 steps against 3, a snapshot, a fresh
  model restored from it and 3 more, bitwise in every parameter and
  AdamW leaf.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import (_tree_flatten_with_names,
                                                 _tree_unflatten)
from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, init_state, make_loss_fn,
                                  make_train_step)

pytestmark = pytest.mark.gpu

BAND = 1e-4
LR = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(arch, **kw):
    extra = ({"n_experts": 4, "top_k": 2, "moe_d_ff": 64}
             if "moe" in arch else {})
    return dataclasses.replace(
        get_config(arch), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=512, **extra, **kw)


def _batch(vocab, seed=0, b=4, s=64):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": g.integers(0, vocab, (b, s)).astype(np.int32)}


def _value_and_grad(model, batch):
    names, leaves, td = _tree_flatten_with_names(model.params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    loss = make_loss_fn(model, loss_chunk=32)(_tree_unflatten(td, xs), batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, xs)))


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_card_step_matches_cpu_in_float32(cuda, arch):
    cfg = _cfg(arch, dtype="float32")
    card = build_model(cfg, cuda, q_chunk=32, kv_chunk=32)
    card.init(0)
    cpu = build_model(cfg, "cpu", q_chunk=32, kv_chunk=32)
    cpu.load_params(card.params)
    batch = _batch(cfg.vocab)
    lg, gg = _value_and_grad(card, batch)
    lc, gc = _value_and_grad(cpu, batch)
    assert abs(lg.item() - lc.item()) <= BAND * abs(lc.item())
    for name in gc:
        assert gg[name].device == cuda
        assert _rel(gg[name], gc[name]) <= BAND, name
    opt = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    sg, _ = make_train_step(card, opt, loss_chunk=32)(
        {"params": card.params, "opt": init_state(card.params)}, batch)
    sc, _ = make_train_step(cpu, opt, loss_chunk=32)(
        {"params": cpu.params, "opt": init_state(cpu.params)}, batch)
    for (name, a), b in zip(zip(*_tree_flatten_with_names(sg)[:2]),
                            _tree_flatten_with_names(sc)[1]):
        np.testing.assert_allclose(a.detach().cpu().double().numpy(),
                                   b.detach().double().numpy(), rtol=1e-3,
                                   atol=1.5 * 2 * LR, err_msg=name)


def test_train_step_is_repeatable_on_the_card(cuda):
    cfg = _cfg("granite-moe-1b-a400m")
    model = build_model(cfg, cuda, q_chunk=64, kv_chunk=64)
    model.init(1)
    g = np.random.default_rng(2)
    batch = {"tokens": g.integers(0, 16, (8, 256)).astype(np.int32),
             "labels": g.integers(0, cfg.vocab, (8, 256)).astype(np.int32)}
    l1, g1 = _value_and_grad(model, batch)
    l2, g2 = _value_and_grad(model, batch)
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    opt = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    step = make_train_step(model, opt, loss_chunk=64)
    start = {"params": model.params, "opt": init_state(model.params)}
    a, _ = step(start, batch)
    b, _ = step(start, batch)
    for x, y in zip(_tree_flatten_with_names(a)[1],
                    _tree_flatten_with_names(b)[1]):
        assert torch.equal(x, y)


def test_kill_and_resume_is_bitwise_on_the_card(cuda, tmp_path):
    cfg = _cfg("granite-moe-1b-a400m")
    kw = dict(steps=6, batch=4, seq=64, lr=2e-3, device=cuda,
              log=lambda *a: None)
    whole = train(cfg, **kw)["state"]
    d = str(tmp_path / "ck")
    train(cfg, ckpt_dir=d, ckpt_every=3, stop_at=3, **kw)
    assert Checkpointer(d).latest_step() == 3
    out = train(cfg, ckpt_dir=d, ckpt_every=3, **kw)
    assert out["start_step"] == 3 and len(out["losses"]) == 3
    a, b = _tree_flatten_with_names(whole), _tree_flatten_with_names(
        out["state"])
    assert a[0] == b[0]
    for name, x, y in zip(a[0], a[1], b[1]):
        assert x.device == cuda and torch.equal(x, y), name
