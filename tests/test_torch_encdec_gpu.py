"""The encoder-decoder (whisper-small) and the VLM (qwen2-vl-72b, M-RoPE)
on the card.

Marked ``gpu``: without a CUDA device every test skips (the ``cuda``
fixture decides, never import time). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_encdec_gpu.py

This file imports no JAX: the card is held against the port's own CPU
forward, which tests/test_torch_encdec.py and test_torch_vlm.py hold
against the reference. Each family at its reduced config (the widths of
tests/conftest.py's ``reduce_cfg``, written out here) in float32,
weights drawn on the card from seed 0 and copied to a CPU model:

* hidden states, logits and prefill's caches within 1e-4 of max|CPU|
  (the ULP sources of the CPU tests plus cuBLAS's summation order; TF32
  is off);
* on the card, prefill(S) then decode of token S against the full
  sequence's logits at S within 1e-4 of max|full| (the VLM across its
  image block, the decoded token at cache index S on all three
  streams);
* M-RoPE with equal streams bit for bit RoPE on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, rotary

pytestmark = pytest.mark.gpu

BAND = 1e-4
B, S = 2, 32
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=8)
REDUCED = {
    "whisper-small": dict(n_layers=2, n_enc_layers=2, enc_seq=16,
                          n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128),
    "qwen2-vl-72b": dict(n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                         d_ff=128, mrope_sections=(2, 3, 3)),
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


def _positions(n):
    """(3, n) positions: 8 text, a 4 x 4 grid (t fixed), text after."""
    gi, gj = np.divmod(np.arange(16), 4)
    img = np.stack([np.full(16, 8), 8 + gi, 8 + gj])
    t1 = 12 + np.arange(n - 24)
    return np.concatenate([np.stack([np.arange(8)] * 3), img,
                           np.stack([t1] * 3)], 1).astype(np.int64)


def _batch(cfg, n, seed=0, table=None):
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    if cfg.enc_dec:
        return {"tokens": toks, "frames": g.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}, toks
    emb = (g.normal(size=(B, n, cfg.d_model)).astype(np.float32)
           if table is None else table[toks])
    return {"embeds": emb, "positions": np.broadcast_to(
        _positions(n)[:, None], (3, B, n)).copy()}, toks


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_card_forward_matches_cpu_in_float32(cuda, arch):
    cfg = _cfg(arch)
    card = build_model(cfg, cuda, **CHUNKS)
    card.init(0)
    cpu = build_model(cfg, "cpu", **CHUNKS)
    cpu.load_params(card.params)
    batch, _ = _batch(cfg, S)
    assert _rel(card.hidden_seq(batch), cpu.hidden_seq(batch)) <= BAND
    assert _rel(card.logits_seq(batch), cpu.logits_seq(batch)) <= BAND
    lg, cg = card.prefill(batch, S + 4)
    lc, cc = cpu.prefill(batch, S + 4)
    assert _rel(lg, lc) <= BAND
    for a, b in zip(_leaves(cg), _leaves(cc)):
        assert a.device == lg.device and a.shape == b.shape
        assert _rel(a, b) <= BAND


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_decode_matches_full_sequence_on_the_card(cuda, arch):
    cfg = _cfg(arch)
    m = build_model(cfg, cuda, **CHUNKS)
    m.init(2)
    table = m.params["embed"]["table"].cpu().numpy()
    full_batch, toks = _batch(cfg, S + 1, seed=7, table=table)
    if not cfg.enc_dec:         # the decoded token at its cache index S
        full_batch["positions"][:, :, S] = S
    prompt = {k: (v[..., :S] if k == "positions" else
                  v if k == "frames" else v[:, :S])
              for k, v in full_batch.items()}
    full = m.logits_seq(full_batch)
    _, caches = m.prefill(prompt, cache_len=S + 4)
    lg, _ = m.decode(toks[:, S:S + 1], S, caches)
    assert _rel(lg[:, 0], full[:, S]) <= BAND


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_on_text_is_rope_on_the_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 512, 8, 128), generator=g, device=cuda).to(dtype)
    pos = torch.arange(512, device=cuda).expand(4, 512)
    assert torch.equal(rotary.apply_rope(x, pos, 1e6),
                       rotary.apply_mrope(x, pos.expand(3, 4, 512), 1e6,
                                          (16, 24, 24)))
