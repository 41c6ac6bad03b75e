"""The port's encoder-decoder (whisper-small; ``models/encdec.py``,
``models/mlp.py``'s tanh GELU MLP, ``Model`` with ``cfg.enc_dec``: a
``frames`` / ``tokens`` batch) against the JAX package on the CPU, at the
reduced whisper-small (``conftest.reduce_cfg``: 2 encoder and 2 decoder
layers, ``enc_seq`` 16, d 64, 4 heads of 16, d_ff 128, vocab 256),
B = 2, S = 32, on numpy-seeded inputs.

Bands, fixed before the first comparison:

* ``init(seed)``: the leaves drawn by exact ops (ones, zeros: the
  LayerNorms, the biases) bitwise, the others within 1e-6 of max|leaf|
  (the truncated normal's ``erf_inv`` and ``log1p`` differ by an ulp
  between the libraries); the keys are ``split(key, 6 + 2 + 2)`` with 3-5
  unused, as the reference's;
* ``gelu_mlp`` within 1e-6 of max|ref| in float32, where the erf GELU
  (``torch``'s default) misses that band; ``cross_attend`` and
  ``encode`` within 1e-5;
* float32: hidden states, logits, prefill logits and every cache leaf
  (the self-attention's K / V, the cross-attention's ``xk`` / ``xv``),
  two decode steps, teacher forcing (decode after prefill against the
  full sequence), one train step's loss and every gradient leaf, within
  1e-4 of max|ref|;
* bfloat16, block by block: every encoder block, every decoder block of
  prefill (output and caches) and of two decode steps (output and the
  written caches), each given the reference's own input, memory and
  caches as recorded from its eager run, within 3e-2 of max|ref|, and
  the logits from its last hidden state; bfloat16 teacher forcing with
  rtol = atol = 2e-2 (tests/test_models_smoke.py);
* the serving copy: with the LayerNorms' scales and biases perturbed
  away from ones and zeros (which bfloat16 holds exactly), its logits
  equal bit for bit those of the float32 masters cast at each use
  (``cast_at_use``), every LayerNorm leaf stays float32 and every linear
  bias is bfloat16, as the reference casts them;
* the reference's smoke contract: finite logits of the right shape, and
  8 train steps whose last loss is below the first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_family_util as fu
from torch_family_util import one_torch_thread  # noqa: F401
from conftest import reduce_cfg
from repro.models import encdec as renc
from repro.models import mlp as rmlp
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import build_model, encdec, mlp
from repro_torch.models import transformer as tfm
from repro_torch.training import AdamWConfig, make_train_step

ARCH = "whisper-small"
F32_BAND, BF16_BAND, INIT_BAND, MLP_BAND, PART_BAND = (1e-4, 3e-2, 1e-6,
                                                       1e-6, 1e-5)
TOTAL = 270_902_016        # jax.eval_shape of the reference's init
B, S = fu.B, fu.S
EXACT = {"scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def whisper_batch(cfg, seed, n=B, labels=False):
    g = np.random.default_rng(seed)
    out = {"tokens": g.integers(0, cfg.vocab, (n, S)).astype(np.int32),
           "frames": g.normal(size=(n, cfg.enc_seq, cfg.d_model)
                              ).astype(np.float32)}
    if labels:
        out["labels"] = g.integers(0, cfg.vocab, (n, S)).astype(np.int32)
    return out


def train_batch(vocab, seed, n=4):
    """``torch_family_util``'s ``batch_fn``: a whisper batch with labels."""
    return whisper_batch(fu.cfg_of(ARCH), seed, n, labels=True)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _slice(tree, i, dtype=None):
    """Layer i of the reference's stacked blocks as a port tree."""
    return fu._torch_tree(jax.tree.map(lambda t: t[i], tree), dtype)


# -------------------------------------------------------------------- init
def test_init_matches_reference_leaf_by_leaf():
    names = fu.check_init(ARCH, EXACT, INIT_BAND)
    for n in ("pos_table", "enc_pos_table", "enc_final/scale",
              "enc_blocks/ffn/b_up", "dec_blocks/cross/wk",
              "dec_blocks/norm_x/bias"):
        assert n in names, n
    assert "unembed" not in names       # whisper ties its embeddings


def test_full_config_shapes_match_reference():
    cfg = fu.check_full_shapes(ARCH, TOTAL)
    # num_params() leaves out the 40,960-row pos_table's share, and more
    assert cfg.num_params() == 239_212_032 != TOTAL
    shapes = fu.param_shapes(configs.get_config(ARCH))
    assert shapes["pos_table"] == (40_960, 768)
    assert shapes["dec_blocks/cross/wq"] == (12, 768, 768)


# ------------------------------------------------------------------- parts
def test_gelu_mlp_is_the_tanh_form():
    rm, rp, _ = fu.pair(ARCH)
    p = jax.tree.map(lambda t: t[0], rp["enc_blocks"]["ffn"])
    port = _slice(rp["enc_blocks"]["ffn"], 0)
    # biases away from zero, so they count
    g = np.random.default_rng(3)
    p = dict(p, b_up=jnp.asarray(_x((128,), 4)), b_down=jnp.asarray(
        _x((64,), 5)))
    port = dict(port, b_up=torch.from_numpy(np.asarray(p["b_up"])),
                b_down=torch.from_numpy(np.asarray(p["b_down"])))
    x = 2.0 * g.normal(size=(B, S, 64)).astype(np.float32)
    want = np.asarray(rmlp.gelu_mlp(p, jnp.asarray(x)))
    got = mlp.gelu_mlp(port, torch.from_numpy(x))
    assert fu.rel(got.numpy(), want) <= MLP_BAND
    h = torch.from_numpy(x) @ port["w_up"] + port["b_up"]
    erf = F.gelu(h) @ port["w_down"] + port["b_down"]
    assert fu.rel(erf.numpy(), want) > 10 * MLP_BAND


def test_cross_attention_and_encoder_match_reference():
    rm, rp, _ = fu.pair(ARCH)
    cfg = rm.cfg
    p = jax.tree.map(lambda t: t[1], rp["dec_blocks"]["cross"])
    port = _slice(rp["dec_blocks"]["cross"], 1)
    x, mem = _x((B, S, 64), 1), _x((B, cfg.enc_seq, 64), 2)
    k, v = renc.cross_kv(cfg, p, jnp.asarray(mem))
    kp, vp = encdec.cross_kv(cfg, port, torch.from_numpy(mem))
    assert fu.rel(kp.numpy(), np.asarray(k)) <= PART_BAND
    want = renc.cross_attend(cfg, p, jnp.asarray(x), k, v)
    got = encdec.cross_attend(cfg, port, torch.from_numpy(x), kp, vp)
    assert fu.rel(got.numpy(), np.asarray(want)) <= PART_BAND
    want = renc.encode(cfg, rm.ctx, rp, jnp.asarray(mem))
    got = encdec.encode(cfg, fu._torch_tree(rp), torch.from_numpy(mem))
    assert tuple(got.shape) == (B, cfg.enc_seq, 64)
    assert fu.rel(got.numpy(), np.asarray(want)) <= PART_BAND


# ------------------------------------------------------------------ model
def test_hidden_and_logits_match_reference():
    rm, rp, pm = fu.pair(ARCH)
    batch = whisper_batch(rm.cfg, 0)
    h_r = rm.hidden_seq(rp, _j(batch), remat=False)
    h = pm.hidden_seq(batch)
    assert h.dtype == torch.float32
    fu._close(h, h_r, F32_BAND, "hidden")
    fu._close(pm.logits_seq(batch), rm.logits_seq(rp, _j(batch)), F32_BAND,
              "logits")


def test_prefill_caches_and_decode_match_reference():
    rm, rp, pm = fu.pair(ARCH, seed=2)
    batch = whisper_batch(rm.cfg, 2)
    toks = fu.tokens(rm.cfg.vocab, (B, 2), seed=2)
    lr, cr = rm.prefill(rp, _j(batch), S + 8)
    lp, cp = pm.prefill(batch, S + 8)
    fu._close(lp, lr, F32_BAND, "prefill logits")
    assert sorted(cp) == sorted(cr) == ["k", "v", "xk", "xv"]
    for n in cr:
        assert tuple(cp[n].shape) == cr[n].shape, n
        fu._close(cp[n], cr[n], F32_BAND, n)
    assert tuple(cp["xk"].shape) == (2, B, 16, 4, 16)
    for i in range(2):
        dr, cr = rm.decode(rp, jnp.asarray(toks[:, i:i + 1]),
                           jnp.int32(S + i), cr)
        dp, cp = pm.decode(toks[:, i:i + 1], S + i, cp)
        assert tuple(dp.shape) == (B, 1, rm.cfg.vocab)
        fu._close(dp, dr, F32_BAND, f"decode {i}")
    for n in cr:
        fu._close(cp[n], cr[n], F32_BAND, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_full_sequence(dtype):
    cfg = reduce_cfg(configs.get_config(ARCH), dtype=dtype)
    m = build_model(cfg, device="cpu", **fu.CHUNKS)
    m.init(2)
    g = np.random.default_rng(7)
    toks = g.integers(0, cfg.vocab, (B, S + 1))
    frames = g.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    full = m.logits_seq({"tokens": toks, "frames": frames}).float()
    _, caches = m.prefill({"tokens": toks[:, :S], "frames": frames}, S + 4)
    lg, _ = m.decode(toks[:, S:S + 1], S, caches)
    got, want = lg[:, 0].float().numpy(), full[:, S].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    d = fu.rel(got, want)
    print(f"teacher forcing ({dtype}): {d:.3e} of max|ref|")
    if dtype == "float32":
        assert d <= F32_BAND


class _Record:
    """Records the reference's ``encdec.<name>`` calls (run eagerly)."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __enter__(self):
        self.orig = orig = getattr(renc, self.name)

        def rec(*a, **kw):
            out = orig(*a, **kw)
            self.calls.append((a, out))
            return out
        setattr(renc, self.name, rec)
        return self

    def __exit__(self, *a):
        setattr(renc, self.name, self.orig)
        return False


def test_blocks_match_reference_in_bfloat16():
    """Each block's input is the first LayerNorm's input of the block
    (the reference's ``_ln`` calls, in order: 2 an encoder block, then
    ``enc_final``; 3 a decoder block, then ``final_norm``), its output
    the next block's input."""
    rm, rp, pm = fu.pair(ARCH, "bfloat16", seed=2)
    cfg, bf = pm.cfg, torch.bfloat16
    batch = whisper_batch(cfg, 2)
    toks = fu.tokens(cfg.vocab, (B, 2), seed=2)
    Le, L = cfg.n_enc_layers, cfg.n_layers
    caches = []
    with jax.disable_jit(), _Record("_ln") as ln:
        lr, cr = rm.prefill(rp, _j(batch), S + 8)
        caches.append(cr)
        for i in range(2):
            _, cr = rm.decode(rp, jnp.asarray(toks[:, i:i + 1]),
                              jnp.int32(S + i), cr)
            caches.append(cr)
    xs = [fu._torch_tree(a[0], bf) for a, _ in ln.calls]
    assert len(xs) == 2 * Le + 1 + 3 * (3 * L + 1)
    worst = 0.0

    def close(got, want, what):
        nonlocal worst
        assert got.dtype == bf, what
        worst = max(worst, fu._close(got, want, BF16_BAND, what))

    enc = [tfm.cast_tree(_slice(rp["enc_blocks"], i), bf) for i in range(Le)]
    dec = [tfm.cast_tree(_slice(rp["dec_blocks"], i), bf) for i in range(L)]
    for i in range(Le):
        close(encdec.enc_block(cfg, enc[i], xs[2 * i]), xs[2 * i + 2],
              f"encoder block {i}")
    memory = fu._torch_tree(ln.calls[2 * Le][1], bf)
    off = 2 * Le + 1
    for i in range(L):
        h, cache = encdec.dec_block_prefill(cfg, dec[i], xs[off + 3 * i],
                                            memory, S + 8, q_chunk=16,
                                            kv_chunk=16)
        close(h, xs[off + 3 * i + 3], f"prefill block {i}")
        for name, c in zip(encdec.CACHE_KEYS, cache):
            close(c, caches[0][name][i], f"prefill {name} {i}")
    for step in range(2):
        off += 3 * L + 1
        for i in range(L):
            cache = tuple(fu._torch_tree(caches[step][name][i], bf)
                          for name in encdec.CACHE_KEYS)
            h, cache = encdec.dec_block_decode(cfg, dec[i], xs[off + 3 * i],
                                               S + step, cache)
            close(h, xs[off + 3 * i + 3], f"decode {step} block {i}")
            for name, c in zip(("k", "v"), cache):
                close(c, caches[step + 1][name][i], f"decode {step} {name}")
    last = xs[2 * Le + 1 + 3 * L]
    norm = pm.compute_params["final_norm"]
    lg = encdec._ln(last, norm, cfg.norm_eps)[:, -1] @ pm._unembed_c().T
    close(lg, lr, "logits")
    print(f"largest distance {worst:.3e}")


def _perturbed_masters(seed=5):
    """A bfloat16 whisper's float32 masters with every LayerNorm's scale
    and bias drawn off ones and zeros."""
    cfg = reduce_cfg(configs.get_config(ARCH))
    m = build_model(cfg, "cpu", **fu.CHUNKS)
    params = m.init(3)
    g = torch.Generator().manual_seed(seed)

    def perturb(t):
        if tfm._is_layer_norm(t):
            t["scale"] += 0.3 * torch.randn(t["scale"].shape, generator=g)
            t["bias"] += 0.3 * torch.randn(t["bias"].shape, generator=g)
        elif isinstance(t, dict):
            for v in t.values():
                perturb(v)
    with torch.no_grad():
        perturb(params)
    return cfg, params


def test_serving_copy_keeps_layer_norms_float32():
    cfg, params = _perturbed_masters()
    m = build_model(cfg, "cpu", **fu.CHUNKS)
    m.use_params(params)
    kept = set()
    for name, leaf in fu._flat(m.compute_params).items():
        last = name.split("/")[-1]
        if leaf.dtype == torch.float32:
            kept.add(name)
            assert last in ("scale", "bias"), name
        else:
            assert leaf.dtype == torch.bfloat16, name
    # stacked: norm1 / norm2 of the encoder, norm1 / norm_x / norm2 of the
    # decoder, enc_final, final_norm, each a scale and a bias
    assert len(kept) == 2 * 7
    assert all(fu._flat(m.compute_params)[f"{blk}/{b}"].dtype
               == torch.bfloat16 for blk in ("enc_blocks/attn",
                                             "dec_blocks/attn")
               for b in ("bq", "bk", "bv", "bo"))
    batch = whisper_batch(cfg, 6)
    served = m.logits_seq(batch)
    masters = build_model(cfg, "cpu", cast_at_use=True, **fu.CHUNKS)
    masters.use_params(params)
    assert torch.equal(served, masters.logits_seq(batch))
    # the perturbation shows: LayerNorms rounded to bfloat16 move logits
    rounded = build_model(cfg, "cpu", **fu.CHUNKS)
    rounded.use_params({k: (tfm.cast_tree(v, torch.bfloat16) if
                            tfm._is_layer_norm(v) else v)
                        for k, v in params.items()})
    assert not torch.equal(served, rounded.logits_seq(batch))
    # and the reference (reading its masters' LayerNorms in float32)
    # lands within the bfloat16 band
    rm = fu.rbuild(fu.cfg_of(ARCH, "bfloat16"), **fu.CHUNKS)
    want = rm.logits_seq(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                      params), _j(batch))
    assert fu.rel(served.float().numpy(), fu.as_np(want)) <= BF16_BAND


# --------------------------------------------------------------- training
def test_loss_and_gradients_match_reference():
    # the self-attention's key bias adds one vector to every key: each
    # query's scores move by a constant, which the softmax ignores, so its
    # gradient is exactly zero and only rounding noise is compared
    cfg = fu.cfg_of(ARCH)
    out = fu.check_grads(ARCH, F32_BAND, whisper_batch(cfg, 8, 4,
                                                       labels=True),
                         zero={"enc_blocks/attn/bk", "dec_blocks/attn/bk"})
    assert len(out) == len(fu.param_shapes(cfg))


def test_train_step_matches_reference():
    names = fu.check_train_step(ARCH, F32_BAND, batch_fn=train_batch)
    assert "dec_blocks/cross/wv" in names


def test_remat_is_bitwise():
    fu.check_remat_bitwise(ARCH, batch_fn=train_batch)


def test_train_snapshots_cross_packages(tmp_path):
    names = fu.check_snapshot_crossing(ARCH, tmp_path, batch_fn=train_batch)
    assert "opt/m/enc_blocks/norm1/scale" in names


# ------------------------------------------- the reference's smoke contract
def test_forward_shapes_no_nan():
    cfg = reduce_cfg(configs.get_config(ARCH))
    m = build_model(cfg, "cpu", **fu.CHUNKS)
    m.init(0)
    logits = m.logits_seq(whisper_batch(cfg, 0))
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


def test_train_step_decreases_loss():
    cfg = reduce_cfg(configs.get_config(ARCH))
    m = build_model(cfg, "cpu", **fu.CHUNKS)
    state = fu.init_train_state(m, 1)
    step = make_train_step(m, AdamWConfig(lr=3e-3, warmup_steps=2,
                                          total_steps=30), loss_chunk=16)
    batch = whisper_batch(cfg, 1, labels=True)
    losses = []
    for _ in range(8):
        state, met = step(state, batch)
        losses.append(met["loss"].item())
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


def test_serve_cli_whisper(capsys):
    assert serve.main(["--mode", "lm", "--arch", ARCH, "--preset", "tiny",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "16", "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out
