"""MLA (deepseek-v2-236b), the Mamba hybrid (jamba-v0.1-52b) and xLSTM
(xlstm-350m) on the card.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_families_gpu.py

This file imports no JAX: the card is held against the port's own CPU
forward, which tests/test_torch_mla.py, test_torch_mamba.py and
test_torch_xlstm.py hold against the reference. Each family at its
reduced config (two periods, d 64; the widths of tests/conftest.py's
``reduce_cfg``, written out here) in float32, weights drawn on the card
from seed 0 and copied to a CPU model:

* hidden states, logits and prefill's caches or states within 1e-4 of
  max|CPU| (the ULP sources of the CPU tests plus cuBLAS's summation
  order; TF32 is off);
* on the card, prefill(S) then decode of token S against the full
  sequence's logits at S within 1e-4 of max|full|, at a capacity factor
  that drops nothing (drops are a batch-level policy).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model

pytestmark = pytest.mark.gpu

BAND = 1e-4
B, S = 2, 32
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=8)
_MOE = dict(n_experts=4, top_k=2, moe_d_ff=32, moe_capacity_factor=8.0)
REDUCED = {
    "deepseek-v2-236b": dict(n_layers=2, n_heads=4, n_kv_heads=4,
                             head_dim=16, kv_lora_rank=32, q_lora_rank=48,
                             qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
                             d_ff=128, **_MOE),
    "jamba-v0.1-52b": dict(n_layers=16, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, **_MOE),
    "xlstm-350m": dict(n_layers=12, n_heads=4, n_kv_heads=4, head_dim=16,
                       d_ff=0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(arch):
    return dataclasses.replace(get_config(arch), d_model=64, vocab=256,
                               dtype="float32", **REDUCED[arch])


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, tuple):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_card_forward_matches_cpu_in_float32(cuda, arch):
    cfg = _cfg(arch)
    card = build_model(cfg, cuda, **CHUNKS)
    card.init(0)
    cpu = build_model(cfg, "cpu", **CHUNKS)
    cpu.load_params(card.params)
    batch = {"tokens": _tokens(cfg.vocab, (B, S))}
    assert _rel(card.hidden_seq(batch), cpu.hidden_seq(batch)) <= BAND
    assert _rel(card.logits_seq(batch), cpu.logits_seq(batch)) <= BAND
    lg, cg = card.prefill(batch, S + 4)
    lc, cc = cpu.prefill(batch, S + 4)
    assert _rel(lg, lc) <= BAND
    for a, b in zip(_leaves(cg), _leaves(cc)):
        assert a.device == lg.device and a.shape == b.shape
        if b.abs().max() > 0:
            assert _rel(a, b) <= BAND
        else:
            assert not a.any()


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_decode_matches_full_sequence_on_the_card(cuda, arch):
    cfg = _cfg(arch)
    m = build_model(cfg, cuda, **CHUNKS)
    m.init(2)
    toks = _tokens(cfg.vocab, (B, S + 1), seed=7)
    full = m.logits_seq({"tokens": toks})
    _, caches = m.prefill({"tokens": toks[:, :S]}, cache_len=S + 4)
    lg, _ = m.decode(toks[:, S:S + 1], S, caches)
    assert _rel(lg[:, 0], full[:, S]) <= BAND
