"""The port's dense LM serving path (``repro_torch.configs``, ``models``,
``serving.sampler`` / ``serve_step``) against the JAX package on the CPU.

The same numpy-seeded tokens and inputs go through both packages at
reduced configs (``conftest.reduce_cfg``). Bands, fixed before the first
comparison:

* float32 compute: hidden states, logits and caches within 1e-4 of
  max|ref| (ULP sources: RoPE's cos / sin at angles up to a few hundred
  radians, ``rsqrt`` in ``rms_norm``, summation order of XLA-CPU against
  torch-CPU);
* bfloat16 compute: within 3e-2 of max|ref| (the two frameworks round
  bfloat16 at other places);
* ``init(seed)``: every leaf within 2e-6 of max|leaf| (the truncated
  normal's ``erf_inv`` and ``log1p`` differ by an ulp);
* greedy tokens equal in float32, each step's top-two logit gap over
  100x the logits band (so that a tie fails loudly instead of flaking);
  ``temperature`` draws equal under the same key.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduce_cfg
from repro import configs as rconfigs
from repro.configs import svm_paper as rsvm_paper
from repro.data import make_lm_tokens as ref_make_lm_tokens
from repro.models import attention as rattn
from repro.models import build_model as rbuild
from repro.models import common as rcommon
from repro.models import mlp as rmlp
from repro.models import rotary as rrotary
from repro.serving import generate as rgenerate
from repro.serving import sampler as rsampler
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import _tree_flatten_with_names
from repro_torch.configs import svm_paper
from repro_torch.core import prng
from repro_torch.core.convert import lm_params_from_reference
from repro_torch.data import make_lm_tokens
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, common, mlp, rotary
from repro_torch.models.model import _flat
from repro_torch.serving import generate, sampler

F32_BAND, BF16_BAND, INIT_BAND = 1e-4, 3e-2, 2e-6
DENSE = ("smollm-135m", "granite-3-2b", "yi-34b")
ARCHS = rconfigs.list_archs()
B, S = 2, 32


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(x):
    """A torch or jax array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _band(dtype: str) -> float:
    return F32_BAND if dtype == "float32" else BF16_BAND


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _pair(arch, dtype, seed=0, **kw):
    """(reference model, its params, the port's model with those weights)
    at the reduced config."""
    cfg = reduce_cfg(rconfigs.get_config(arch), dtype=dtype, **kw)
    rm = rbuild(cfg, q_chunk=16, kv_chunk=16)
    rp = rm.init(jax.random.PRNGKey(seed))
    names, leaves, _ = _tree_flatten_with_names(
        jax.tree.map(np.asarray, rp))
    pm = lm_params_from_reference(dataclasses.asdict(cfg),
                                  dict(zip(names, leaves)), device="cpu",
                                  q_chunk=16, kv_chunk=16)
    return rm, rp, pm


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_model_config_field_for_field(arch):
    ref, port = rconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.num_params() == ref.num_params()
    assert port.active_params() == ref.active_params()
    for prop in ("attention_free", "subquadratic", "layer_period",
                 "d_inner", "dt_rank"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for layer in range(ref.n_layers):
        for fn in ("is_attn_layer", "is_moe_layer", "is_slstm_layer"):
            assert getattr(port, fn)(layer) == getattr(ref, fn)(layer)


def test_shapes_applicable_and_arch_list():
    assert configs.list_archs() == rconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    for arch in ARCHS:
        for name in rconfigs.SHAPES:
            assert configs.applicable(configs.get_config(arch),
                                      configs.SHAPES[name]) == \
                rconfigs.applicable(rconfigs.get_config(arch),
                                    rconfigs.SHAPES[name])
    assert configs.get_config("smollm-135m").num_params() == 134_515_008
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", ["dna_lin_em_cls", "year_lin_em_svr",
                                  "news20_krn_em_cls", "mnist8m_lin_mc_mlt"])
def test_svm_paper_configs(name):
    ref = dataclasses.asdict(getattr(rsvm_paper, name)())
    port = dataclasses.asdict(getattr(svm_paper, name)())
    assert {k: v for k, v in port.items() if k in ref} == ref


# ------------------------------------------------------------ weights, init
@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_reference_leaf_by_leaf(arch):
    cfg = reduce_cfg(rconfigs.get_config(arch))
    rp = rbuild(cfg).init(jax.random.PRNGKey(3))
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray, rp))
    model = build_model(configs.ModelConfig(**dataclasses.asdict(cfg)),
                        device="cpu")
    port = _flat(model.init(3))
    assert sorted(port) == sorted(names)
    for name, want in zip(names, leaves):
        got = port[name].numpy()
        assert got.shape == want.shape and got.dtype == np.float32, name
        assert _rel(got, want) <= INIT_BAND, name
    assert model.num_params() == cfg.num_params()


def test_converter_round_trip():
    _, rp, pm = _pair("smollm-135m", "float32", seed=5)
    names, leaves, _ = _tree_flatten_with_names(jax.tree.map(np.asarray, rp))
    pnames, pleaves, _ = _tree_flatten_with_names(pm.params)
    assert pnames == names
    for want, got in zip(leaves, pleaves):
        np.testing.assert_array_equal(got.numpy(), want)
    # the cast copy has the bits of the reference's per-use cast
    _, _, pb = _pair("smollm-135m", "bfloat16", seed=5)
    wq = pb.compute_params["layers"]["pos0"]["attn"]["wq"]
    want = np.asarray(rp["layers"]["pos0"]["attn"]["wq"].astype(
        jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(wq.float().numpy(), want)
    assert pb.compute_params["layers"]["pos0"]["norm1"].dtype == \
        torch.float32
    bad = _flat(pm.params)
    bad["layers/pos0/attn/wq"] = bad["layers/pos0/attn/wq"][:, :-1]
    with pytest.raises(ValueError, match="shapes"):
        lm_params_from_reference(dataclasses.asdict(pm.cfg), {
            k: v.numpy() for k, v in bad.items()}, device="cpu")
    del bad["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_reference(dataclasses.asdict(pm.cfg), {
            k: v.numpy() for k, v in bad.items()}, device="cpu")


# ----------------------------------------------------------- building blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_swiglu(dtype):
    g = np.random.default_rng(1)
    x = g.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(300, 309, dtype=np.int32), (2, 1))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    scale = g.uniform(0.5, 1.5, 16).astype(np.float32)
    assert _rel(_np(common.rms_norm(tx, torch.from_numpy(scale), 1e-5)),
                _np(rcommon.rms_norm(jx, jnp.asarray(scale), 1e-5))) \
        <= _band(dtype)
    bias = g.normal(size=16).astype(np.float32)
    assert _rel(_np(common.layer_norm(tx, torch.from_numpy(scale),
                                      torch.from_numpy(bias), 1e-5)),
                _np(rcommon.layer_norm(jx, jnp.asarray(scale),
                                       jnp.asarray(bias), 1e-5))) \
        <= _band(dtype)
    np.testing.assert_allclose(
        rotary.rope_freqs(16, 1e4).numpy(),
        np.asarray(rrotary.rope_freqs(16, 1e4)), rtol=2e-7)
    assert _rel(_np(rotary.apply_rope(tx, torch.from_numpy(pos), 1e4)),
                _np(rrotary.apply_rope(jx, jnp.asarray(pos), 1e4))) \
        <= _band(dtype)
    w = {k: (g.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)),
                      ("w_down", (24, 16)))}
    h = x[:, :, 0]
    got = mlp.swiglu({k: torch.from_numpy(v).to(td) for k, v in w.items()},
                     torch.from_numpy(h).to(td))
    want = rmlp.swiglu({k: jnp.asarray(v) for k, v in w.items()},
                       jnp.asarray(h).astype(jd))
    assert _rel(_np(got), _np(want)) <= _band(dtype)


def test_initializers_match_reference():
    key = jax.random.PRNGKey(11)
    want = np.asarray(rcommon.dense_init(key, 37, 21, scale=0.3))
    got = common.dense_init(prng.PRNGKey(11), 37, 21, scale=0.3).numpy()
    assert _rel(got, want) <= INIT_BAND
    want = np.asarray(rcommon.embed_init(key, 50, 8))
    got = common.embed_init(prng.PRNGKey(11), 50, 8).numpy()
    assert _rel(got, want) <= INIT_BAND
    assert np.abs(got).max() < 2 * 0.02
    np.testing.assert_array_equal(
        np.stack([np.asarray(k) for k in rcommon.split_keys(key, 5)]),
        torch.stack(common.split_keys(prng.PRNGKey(11), 5)).numpy())


# (B, Sq, Skv, H, KVH, q_chunk, kv_chunk, q_offset, skip)
ATTN_CASES = [
    (2, 32, 32, 4, 4, 8, 8, 0, False),       # G = 1
    (2, 32, 32, 4, 2, 8, 16, 0, True),       # G = 2, skipped blocks
    (1, 24, 24, 6, 2, 8, 8, 0, True),        # G = 3
    (2, 21, 21, 6, 2, 8, 8, 0, False),       # non-divisible: one chunk
    (1, 16, 48, 4, 2, 8, 16, 32, False),     # q_offset (the last rows)
    (1, 16, 48, 4, 2, 8, 16, 32, True),
    (2, 12, 12, 3, 1, 4, 4, 0, False),       # G = 3, KVH = 1
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"c{i}" for i in range(len(ATTN_CASES))])
def test_blockwise_attn(case, dtype):
    Bq, Sq, Skv, H, KVH, qc, kvc, off, skip = case
    g = np.random.default_rng(hash(case) % 2**32)
    q = g.normal(size=(Bq, Sq, H, 16)).astype(np.float32)
    k = g.normal(size=(Bq, Skv, KVH, 16)).astype(np.float32)
    v = g.normal(size=(Bq, Skv, KVH, 16)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = rattn.blockwise_attn(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), q_offset=off,
        q_chunk=qc, kv_chunk=kvc, skip_masked_blocks=skip)
    got = attention.blockwise_attn(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), q_offset=off,
        q_chunk=qc, kv_chunk=kvc, skip_masked_blocks=skip)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    assert _rel(_np(got), _np(want)) <= _band(dtype)
    if skip:   # skipping the hidden blocks does not change the numbers
        plain = attention.blockwise_attn(
            *(torch.from_numpy(a).to(td) for a in (q, k, v)), q_offset=off,
            q_chunk=qc, kv_chunk=kvc)
        assert torch.equal(got, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [17, "per-row"])
def test_decode_attn(valid, dtype):
    g = np.random.default_rng(4)
    q = g.normal(size=(3, 1, 6, 16)).astype(np.float32)
    kc = g.normal(size=(3, 24, 2, 16)).astype(np.float32)
    vc = g.normal(size=(3, 24, 2, 16)).astype(np.float32)
    vl = np.array([5, 24, 11], np.int32) if valid == "per-row" else valid
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = rattn.decode_attn(*(jnp.asarray(a).astype(jd) for a in
                               (q, kc, vc)), jnp.asarray(vl))
    got = attention.decode_attn(*(torch.from_numpy(a).to(td) for a in
                                  (q, kc, vc)),
                                torch.as_tensor(vl) if valid == "per-row"
                                else vl)
    assert got.dtype == td
    assert _rel(_np(got), _np(want)) <= _band(dtype)


# ------------------------------------------------------------ whole decoder
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_hidden_and_logits_match_reference(arch, dtype):
    rm, rp, pm = _pair(arch, dtype)
    toks = _tokens(pm.cfg.vocab, (B, S))
    batch = {"tokens": jnp.asarray(toks)}
    h = pm.hidden_seq({"tokens": toks})
    assert h.dtype == getattr(torch, dtype)
    assert _rel(_np(h), _np(rm.hidden_seq(rp, batch, remat=False))) \
        <= _band(dtype)
    lg = pm.logits_seq({"tokens": torch.from_numpy(toks)})
    assert tuple(lg.shape) == (B, S, pm.cfg.vocab)
    assert _rel(_np(lg), _np(rm.logits_seq(rp, batch))) <= _band(dtype)
    np.testing.assert_array_equal(pm.unembed().numpy(),
                                  np.asarray(rm.unembed(rp)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_caches_and_decode_logits(dtype):
    rm, rp, pm = _pair("granite-3-2b", dtype, seed=2)
    toks = _tokens(pm.cfg.vocab, (B, S + 1), seed=2)
    lr, cr = rm.prefill(rp, {"tokens": jnp.asarray(toks[:, :S])}, S + 8)
    lp, cp = pm.prefill({"tokens": toks[:, :S]}, S + 8)
    assert _rel(_np(lp), _np(lr)) <= _band(dtype)
    for i in range(2):
        assert cp["pos0"][i].shape == cr["pos0"][i].shape
        assert cp["pos0"][i].dtype == getattr(torch, dtype)
        assert _rel(_np(cp["pos0"][i]), _np(cr["pos0"][i])) <= _band(dtype)
        assert not cp["pos0"][i][:, :, S:].any()     # zero-padded
    dr, cr = rm.decode(rp, jnp.asarray(toks[:, S:S + 1]), jnp.int32(S), cr)
    dp, cp2 = pm.decode(toks[:, S:S + 1], S, cp)
    assert cp2["pos0"][0] is cp["pos0"][0]           # written in place
    assert tuple(dp.shape) == (B, 1, pm.cfg.vocab)
    assert _rel(_np(dp), _np(dr)) <= _band(dtype)
    assert _rel(_np(cp["pos0"][0][:, :, S]), _np(cr["pos0"][0][:, :, S])) \
        <= _band(dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_port_prefill_decode_matches_full_sequence(arch):
    """The reference's own teacher-forcing test on the port: prefill(S)
    then decode token S equals the full-sequence logits at S (2e-2)."""
    cfg = reduce_cfg(configs.get_config(arch))
    m = build_model(cfg, device="cpu", q_chunk=16, kv_chunk=16)
    m.init(2)
    toks = _tokens(cfg.vocab, (B, S + 1), seed=7)
    full = m.logits_seq({"tokens": toks}).float()
    _, caches = m.prefill({"tokens": toks[:, :S]}, cache_len=S + 4)
    lg, _ = m.decode(toks[:, S:S + 1], S, caches)
    np.testing.assert_allclose(lg[:, 0].float().numpy(),
                               full[:, S].numpy(), rtol=2e-2, atol=2e-2)
    caches = m.init_cache(B, S + 4)
    assert caches["pos0"][0].dtype == torch.bfloat16
    assert tuple(caches["pos0"][0].shape) == (cfg.n_layers, B, S + 4,
                                              cfg.n_kv_heads, cfg.head_dim)


def test_greedy_generate_tokens_equal_in_float32():
    """Seed 3 is one whose steps have no near-tie (the gap guard below;
    at a near-tie equal tokens would not be defined)."""
    rm, rp, pm = _pair("smollm-135m", "float32", seed=3)
    toks = _tokens(pm.cfg.vocab, (B, 16), seed=3)
    want = np.asarray(rgenerate(rm, rp, {"tokens": jnp.asarray(toks)},
                                steps=6, cache_len=24))
    got = generate(pm, {"tokens": toks}, steps=6, cache_len=24)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # no near-tie decided a token: each step's top-two gap is far above
    # the logits band
    lg, caches = pm.prefill({"tokens": toks}, 24)
    for i in range(6):
        top = torch.topk(lg.float(), 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).min().item()
        assert gap > 100 * F32_BAND * lg.abs().max().item(), (i, gap)
        lg, caches = pm.decode(torch.from_numpy(want[:, i:i + 1].copy()),
                               16 + i, caches)
        lg = lg[:, 0]
    assert torch.equal(got, generate(pm, {"tokens": toks}, steps=6,
                                     cache_len=24))


def test_temperature_matches_reference_under_one_key():
    g = np.random.default_rng(9)
    lg = g.normal(size=(4, 300)).astype(np.float32) * 3
    for seed, temp, top_k in ((0, 1.0, 0), (1, 0.5, 0), (2, 0.8, 20)):
        want = np.asarray(rsampler.temperature(
            jax.random.PRNGKey(seed), jnp.asarray(lg), temp, top_k))
        got = sampler.temperature(prng.PRNGKey(seed), torch.from_numpy(lg),
                                  temp, top_k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sampler.greedy(torch.from_numpy(lg)).numpy(),
        np.asarray(rsampler.greedy(jnp.asarray(lg))))
    rm, rp, pm = _pair("smollm-135m", "float32", seed=6)
    toks = _tokens(pm.cfg.vocab, (B, 16), seed=6)
    want = np.asarray(rgenerate(rm, rp, {"tokens": jnp.asarray(toks)},
                                steps=5, cache_len=24, temp=0.7, seed=3))
    got = generate(pm, {"tokens": toks}, steps=5, cache_len=24, temp=0.7,
                   seed=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_lm_tokens_bitwise():
    for args in ((5000, 256, 0), (12_345, 49_152, 3)):
        a, b = make_lm_tokens(*args), ref_make_lm_tokens(*args)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- refusals
def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_cfg(configs.get_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no parameters"):
        build_model(cfg, device="cpu").hidden_seq(
            {"tokens": np.zeros((1, 4), np.int32)})


def test_serve_cli_lm_mode(capsys):
    assert serve.main(["--mode", "lm", "--preset", "tiny", "--device", "cpu",
                       "--batch", "3", "--prompt-len", "16",
                       "--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "generated (3, 5) tokens" in out
    assert serve.main(["--preset", "tiny", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--steps", "3", "--temp",
                       "0.7"]) == 0
    assert "generated (2, 3) tokens" in capsys.readouterr().out
