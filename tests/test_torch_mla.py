"""The port's MLA (``models/attention.py``: ``init_mla``, ``_mla_q``,
``_mla_latent``, ``mla_train``, ``mla_prefill``, the absorbed
``mla_decode`` and its latent cache; ``blockwise_attn`` with a value
width other than q's) inside deepseek-v2-236b's MoE decoder, against the
JAX package on the CPU, at the reduced config (``conftest.reduce_cfg``:
2 layers, d 64, 4 heads, kv_lora 32, q_lora 48, rope 8, nope 16, v 16, 4
experts top-2 and 2 shared), B = 2, S = 32, on numpy-seeded inputs.

Bands, fixed before the first comparison:

* ``init(seed)``: the norm scales bitwise, the other leaves within 1e-6
  of max|leaf| (the truncated normal's ``erf_inv`` and ``log1p`` differ
  by an ulp between the libraries);
* ``blockwise_attn`` at q / k 24 wide and v 16 wide, ``mla_train`` and
  the absorbed ``mla_decode``: within 1e-5 of max|ref| in float32; the
  absorbed decode against the expanded sequence's last position on the
  port alone within 1e-5 in float32 (the same function, summed in
  another order);
* float32: hidden states, logits, prefill logits and the latent caches,
  two decode steps' logits and caches, within 1e-4 of max|ref|;
* bfloat16, block by block (``check_blocks_bfloat16``): each block given
  the reference's own input, cache and expert ids, its prefill output and
  latent cache and two decode steps through the serving copy, and the
  logits from the reference's last hidden state, within 3e-2 of
  max|ref|;
* teacher forcing at a capacity factor that drops nothing: within 1e-4
  of max|ref| in float32; rtol = atol = 2e-2 in bfloat16
  (tests/test_models_smoke.py) with the full pass's routes replayed (a
  bfloat16 rounding flips a top-k choice at a near-tie), the free
  distance printed;
* one train step: loss within 1e-4 relative, parameters with rtol 1e-3,
  atol 1.5 x 2 lr (tests/test_training.py); remat off, 'nothing' and
  'dots' bitwise equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_util as fu
from torch_family_util import one_torch_thread  # noqa: F401
from repro.models import attention as rattn
from repro_torch import configs
from repro_torch.models import attention, build_model

ARCH = "deepseek-v2-236b"
F32_BAND, BF16_BAND, INIT_BAND, MIXER_BAND = 1e-4, 3e-2, 1e-6, 1e-5
TOTAL = 239_375_569_920    # jax.eval_shape of the reference's init


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -------------------------------------------------------------------- init
@pytest.mark.parametrize("q_lora", [48, 0])
def test_init_matches_reference_leaf_by_leaf(q_lora):
    names = fu.check_init(ARCH, set(), INIT_BAND, q_lora_rank=q_lora)
    assert any(n.endswith("/attn/wkv_b") for n in names)
    assert any(n.endswith("/attn/wq_a") for n in names) == bool(q_lora)
    assert any(n.endswith("/attn/wq") for n in names) != bool(q_lora)


def test_full_config_shapes_match_reference():
    cfg = fu.check_full_shapes(ARCH, TOTAL)
    assert cfg.num_params() != TOTAL
    shapes = fu.param_shapes(configs.get_config(ARCH))
    assert shapes["layers/pos0/attn/wkv_a"] == (60, 5120, 512 + 64)
    assert shapes["layers/pos0/attn/wkv_b"] == (60, 512, 128 * (128 + 128))
    assert shapes["layers/pos0/moe/moe_gate"] == (60, 160, 5120, 1536)


def test_latent_cache_is_576_values_a_token():
    cfg = configs.get_config(ARCH)
    cache = build_model(fu.cfg_of(ARCH), "cpu").init_cache(2, 8)
    assert [tuple(c.shape) for c in cache["pos0"]] == [(2, 2, 8, 32),
                                                       (2, 2, 8, 8)]
    assert cfg.kv_lora_rank + cfg.qk_rope_dim == 576   # a GQA cache: 32,768


# ------------------------------------------------------------------ mixer
@pytest.mark.parametrize("skip", [False, True])
def test_blockwise_attn_with_a_narrower_value(skip):
    q, k = _x((fu.B, fu.S, 4, 24), 1), _x((fu.B, fu.S, 4, 24), 2)
    v = _x((fu.B, fu.S, 4, 16), 3)
    want = rattn.blockwise_attn(*map(jnp.asarray, (q, k, v)), q_chunk=8,
                                kv_chunk=16, skip_masked_blocks=skip)
    got = attention.blockwise_attn(*map(torch.from_numpy, (q, k, v)),
                                   q_chunk=8, kv_chunk=16,
                                   skip_masked_blocks=skip)
    assert tuple(got.shape) == (fu.B, fu.S, 4, 16)
    assert fu.rel(got.numpy(), np.asarray(want)) <= MIXER_BAND


def test_mla_train_and_absorbed_decode_match_reference():
    rm, rp, _ = fu.pair(ARCH)
    cfg = rm.cfg
    p, port = fu.layer(rp, "pos0", "attn")
    x = _x((fu.B, fu.S + 1, cfg.d_model), seed=5)
    pos = np.broadcast_to(np.arange(fu.S + 1), (fu.B, fu.S + 1))
    want = rattn.mla_train(cfg, p, jnp.asarray(x), jnp.asarray(pos),
                           q_chunk=16, kv_chunk=16)
    got = attention.mla_train(cfg, port, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), q_chunk=16,
                              kv_chunk=16)
    assert fu.rel(got.numpy(), np.asarray(want)) <= MIXER_BAND
    # prefill S, then the absorbed decode of token S
    _, cr = rattn.mla_prefill(cfg, p, jnp.asarray(x[:, :fu.S]),
                              jnp.asarray(pos[:, :fu.S]), fu.S + 4,
                              q_chunk=16, kv_chunk=16)
    dr, _ = rattn.mla_decode(cfg, p, jnp.asarray(x[:, fu.S:]), fu.S, cr)
    _, cp = attention.mla_prefill(cfg, port, torch.from_numpy(x[:, :fu.S]),
                                  torch.from_numpy(pos[:, :fu.S].copy()),
                                  fu.S + 4, q_chunk=16, kv_chunk=16)
    for a, b in zip(cp, cr):
        assert fu.rel(a.numpy(), np.asarray(b)) <= MIXER_BAND
    dp, cp = attention.mla_decode(cfg, port, torch.from_numpy(x[:, fu.S:]),
                                  fu.S, cp)
    assert fu.rel(dp.numpy(), np.asarray(dr)) <= MIXER_BAND
    # absorbed against expanded, on the port alone
    assert fu.rel(dp[:, 0].numpy(), got[:, fu.S].numpy()) <= MIXER_BAND
    assert not cp[0][:, fu.S + 1:].any()


# ---------------------------------------------------------------- decoder
def test_hidden_and_logits_match_reference():
    fu.check_hidden_and_logits(ARCH, F32_BAND)


def test_prefill_caches_and_decode_match_reference():
    fu.check_prefill_and_decode(ARCH, F32_BAND)


def test_blocks_match_reference_in_bfloat16():
    print(f"largest distance {fu.check_blocks_bfloat16(ARCH, BF16_BAND):.3e}")


def test_serving_copy_keeps_the_float32_leaves():
    fu.check_float32_leaves(ARCH, {"router"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_full_sequence(dtype):
    held, free = fu.teacher_forcing(ARCH, dtype)
    print(f"teacher forcing ({dtype}): {held:.3e} of max|ref|, each run "
          f"routing for itself {free:.3e}")
    if dtype == "float32":
        assert held <= F32_BAND


# --------------------------------------------------------------- training
def test_train_step_matches_reference():
    names = fu.check_train_step(ARCH, F32_BAND)
    assert any("/attn/wkv_b" in n for n in names)


def test_remat_policies_are_bitwise_equal():
    fu.check_remat_bitwise(ARCH)
