"""The port's VLM (qwen2-vl-72b's language backbone: GQA with M-RoPE;
``models/rotary.py`` ``apply_mrope``, ``models/attention.py``'s GQA with
``cfg.mrope``, ``Model`` with ``family == "vlm"``: an ``embeds`` /
``positions`` batch) against the JAX package on the CPU, at the reduced
qwen2-vl-72b (``conftest.reduce_cfg``: 2 layers, d 64, 4 heads and 2 KV
heads of 16, M-RoPE sections (2, 3, 3)), B = 2, S = 32, on numpy-seeded
inputs. Prompts take Qwen2-VL's layout: 8 text tokens, a 4 x 4 grid of
patch embeddings (t fixed, h and w over the grid), 8 text tokens resuming
at the grid's largest position + 1.

Bands, fixed before the first comparison:

* ``init(seed)``: the norms bitwise, the other leaves within 1e-6 of
  max|leaf| (the truncated normal's ``erf_inv`` and ``log1p`` differ by
  an ulp between the libraries);
* ``apply_mrope`` within 1e-6 of max|ref|, and bit for bit the port's
  ``apply_rope`` on text positions (t = h = w; the reference's own test
  asks 1e-5, tests/test_models_smoke.py);
* float32: hidden states, logits, prefill logits and caches, two decode
  steps, teacher forcing (decode of the token after prefill against the
  full sequence, on text positions and across the image block with the
  decoded token at its cache index on all three streams, the
  reference's decode position), one train step's loss and every
  gradient leaf, within 1e-4 of max|ref|;
* a 2-micro-batch train step equal to the 1-batch step within 1e-4 (the
  (3, B, S) positions cut on their batch axis), and so a batch of three
  rows cut in three;
* bfloat16, block by block on the reference's own recorded inputs and
  caches (``check_blocks_bfloat16``), within 3e-2 of max|ref|; bfloat16
  teacher forcing with rtol = atol = 2e-2 (tests/test_models_smoke.py);
* the reference's smoke contract: finite logits of the right shape, and
  8 train steps whose last loss is below the first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_util as fu
from torch_family_util import one_torch_thread  # noqa: F401
from conftest import reduce_cfg
from repro.models import attention as rattn
from repro.models import rotary as rrot
from repro.training import train_step as rts
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import attention, build_model, rotary
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training.train_step import _split

ARCH = "qwen2-vl-72b"
F32_BAND, BF16_BAND, INIT_BAND, MROPE_BAND = 1e-4, 3e-2, 1e-6, 1e-6
TOTAL = 72_705_384_448     # jax.eval_shape of the reference's init
B, S = fu.B, fu.S


def layout(n_text0=8, grid=4, n_text1=8):
    """(3, n_text0 + grid**2 + n_text1) M-RoPE positions in Qwen2-VL's
    layout: text on all three streams, then the grid at t fixed and h /
    w over its rows and columns, then text from the largest + 1."""
    t0 = np.arange(n_text0)
    gi, gj = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.full(grid * grid, n_text0), n_text0 + gi,
                    n_text0 + gj])
    start = int(img.max()) + 1
    t1 = start + np.arange(n_text1)
    return np.concatenate([np.stack([t0] * 3), img, np.stack([t1] * 3)],
                          axis=1).astype(np.int32)


def text_positions(n):
    return np.stack([np.arange(n)] * 3).astype(np.int32)


def vlm_batch(d_model, seed, n=B, positions=None, vocab=None):
    """embeds (n, S, D) standard normal (as the reference's smoke test
    draws them), positions (3, n, S) in Qwen2-VL's layout, and labels
    when ``vocab`` is given."""
    g = np.random.default_rng(seed)
    pos = layout() if positions is None else positions
    out = {"embeds": g.normal(size=(n, S, d_model)).astype(np.float32),
           "positions": np.broadcast_to(pos[:, None], (3, n, S)).copy()}
    if vocab is not None:
        out["labels"] = g.integers(0, vocab, (n, S)).astype(np.int32)
    return out


def train_batch(vocab, seed, n=4):
    """``torch_family_util``'s ``batch_fn``: a VLM batch with labels."""
    return vlm_batch(fu.cfg_of(ARCH).d_model, seed, n, vocab=vocab)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -------------------------------------------------------------------- init
def test_init_matches_reference_leaf_by_leaf():
    names = fu.check_init(ARCH, set(), INIT_BAND)
    assert "unembed" in names and "layers/pos0/attn/wq" in names


def test_full_config_shapes_match_reference():
    cfg = fu.check_full_shapes(ARCH, TOTAL)
    assert cfg.num_params() == 72_705_384_448
    assert fu.param_shapes(configs.get_config(ARCH))[
        "layers/pos0/attn/wk"] == (80, 8192, 1024)


# ------------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("kind", ["text", "image", "random"])
def test_mrope_matches_reference(kind):
    x = _x((B, 21, 3, 32))
    if kind == "text":
        pos = np.broadcast_to(text_positions(21)[:, None], (3, B, 21))
    elif kind == "image":
        pos = np.broadcast_to(layout(3, 4, 2)[:, None], (3, B, 21))
    else:
        pos = np.random.default_rng(5).integers(0, 5000, (3, B, 21))
    pos = np.ascontiguousarray(pos).astype(np.int32)
    want = rrot.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4, (4, 6, 6))
    got = rotary.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e4, (4, 6, 6))
    assert fu.rel(got.numpy(), np.asarray(want)) <= MROPE_BAND


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_on_text_is_rope_bitwise(dtype):
    x = torch.from_numpy(_x((B, 40, 4, 128))).to(dtype)
    pos = torch.arange(1000, 1040).expand(B, 40)
    a = rotary.apply_rope(x, pos, 1e6)
    b = rotary.apply_mrope(x, pos.expand(3, B, 40), 1e6, (16, 24, 24))
    assert a.dtype == b.dtype == dtype and torch.equal(a, b)


def test_mrope_refuses_sections_of_another_width():
    with pytest.raises(ValueError, match="sections"):
        rotary.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2),
                           1e4, (2, 3, 2))


def test_gqa_with_mrope_matches_reference():
    rm, rp, _ = fu.pair(ARCH)
    p, port = fu.layer(rp, "pos0", "attn")
    x = _x((B, S, rm.cfg.d_model), seed=3)
    pos = np.broadcast_to(layout()[:, None], (3, B, S)).copy()
    want = rattn.gqa_train(rm.cfg, p, jnp.asarray(x), jnp.asarray(pos),
                           q_chunk=16, kv_chunk=16)
    got = attention.gqa_train(rm.cfg, port, torch.from_numpy(x),
                              torch.from_numpy(pos), q_chunk=16, kv_chunk=16)
    assert fu.rel(got.numpy(), np.asarray(want)) <= F32_BAND


# ------------------------------------------------------------------ model
def test_hidden_and_logits_match_reference():
    rm, rp, pm = fu.pair(ARCH)
    batch = vlm_batch(rm.cfg.d_model, seed=0)
    h_r = rm.hidden_seq(rp, _j(batch), remat=False)
    h = pm.hidden_seq(batch)
    assert h.dtype == torch.float32
    assert fu.rel(h.numpy(), np.asarray(h_r)) <= F32_BAND
    lg_r = rm.logits_seq(rp, _j(batch))
    assert fu.rel(pm.logits_seq(batch).numpy(), np.asarray(lg_r)) <= F32_BAND


def test_prefill_caches_and_decode_match_reference():
    rm, rp, pm = fu.pair(ARCH, seed=2)
    batch = vlm_batch(rm.cfg.d_model, seed=2)
    toks = fu.tokens(rm.cfg.vocab, (B, 2), seed=2)
    lr, cr = rm.prefill(rp, _j(batch), S + 8)
    lp, cp = pm.prefill(batch, S + 8)
    fu._close(lp, lr, F32_BAND, "prefill logits")
    names, leaves, _ = fu._tree_flatten_with_names(cp)
    assert len(leaves) == len(jax.tree.leaves(cr)) == 2
    for n, a, b in zip(names, leaves, jax.tree.leaves(cr)):
        fu._close(a, b, F32_BAND, n)
    for i in range(2):
        dr, cr = rm.decode(rp, jnp.asarray(toks[:, i:i + 1]),
                           jnp.int32(S + i), cr)
        dp, cp = pm.decode(toks[:, i:i + 1], S + i, cp)
        fu._close(dp, dr, F32_BAND, f"decode {i}")
    for n, a, b in zip(names, fu._tree_flatten_with_names(cp)[1],
                       jax.tree.leaves(cr)):
        fu._close(a, b, F32_BAND, n)


def _teacher_forcing(dtype, positions, image, seed=2):
    """prefill(S) of a prompt whose text embeddings are rows of the embed
    table and whose ``image`` entries are patch embeddings drawn at the
    table's scale, then decode of token S at cache index S, against the
    full sequence's logits at S, where the decoded token's three streams
    are S."""
    cfg = reduce_cfg(configs.get_config(ARCH), dtype=dtype)
    m = build_model(cfg, device="cpu", **fu.CHUNKS)
    m.init(seed)
    g = np.random.default_rng(7)
    toks = g.integers(0, cfg.vocab, (B, S + 1))
    table = m.params["embed"]["table"].numpy()
    emb = table[toks]
    emb[:, :S][:, image] = 0.02 * g.normal(size=(B, int(image.sum()),
                                                 cfg.d_model))
    full_pos = np.concatenate([positions, np.full((3, 1), S)], axis=1)
    full = m.logits_seq({"embeds": emb, "positions": np.broadcast_to(
        full_pos[:, None], (3, B, S + 1)).copy()}).float()
    _, caches = m.prefill({"embeds": emb[:, :S], "positions": np.broadcast_to(
        positions[:, None], (3, B, S)).copy()}, S + 4)
    lg, _ = m.decode(toks[:, S:S + 1], S, caches)
    got, want = lg[:, 0].float().numpy(), full[:, S].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    return fu.rel(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["text", "image"])
def test_prefill_decode_matches_full_sequence(dtype, where):
    image = np.zeros(S, bool)
    if where == "image":
        image[8:24] = True                      # layout()'s 4 x 4 grid
    d = _teacher_forcing(dtype, text_positions(S) if where == "text"
                         else layout(), image)
    print(f"teacher forcing ({dtype}, {where}): {d:.3e} of max|ref|")
    if dtype == "float32":
        assert d <= F32_BAND


def test_blocks_match_reference_in_bfloat16():
    cfg = fu.cfg_of(ARCH, "bfloat16")
    d = fu.check_blocks_bfloat16(ARCH, BF16_BAND, prefill_batch={
        k: v for k, v in vlm_batch(cfg.d_model, seed=2).items()})
    print(f"largest distance {d:.3e}")


def test_serving_copy_keeps_the_float32_leaves():
    fu.check_float32_leaves(ARCH, set())


# --------------------------------------------------------------- training
def test_loss_and_gradients_match_reference():
    cfg = fu.cfg_of(ARCH)
    out = fu.check_grads(ARCH, F32_BAND, vlm_batch(cfg.d_model, 8, 4,
                                                   vocab=cfg.vocab))
    # the batch is embeddings: the table gets no gradient in either
    assert out["embed/table"] == 0.0 and out["unembed"] > 0.0


def test_train_step_matches_reference():
    names = fu.check_train_step(ARCH, F32_BAND, batch_fn=train_batch)
    assert "layers/pos0/ffn/w_gate" in names


def test_split_cuts_positions_on_their_batch_axis():
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    parts = _split("positions", pos, 2)
    assert [tuple(p.shape) for p in parts] == [(3, 2, 5), (3, 2, 5)]
    assert torch.equal(torch.cat(parts, dim=1), pos)
    # keyed by name, not by shape: three rows of embeddings cut on axis 0
    parts = _split("embeds", torch.zeros(3, 5, 7), 3)
    assert [tuple(p.shape) for p in parts] == [(1, 5, 7)] * 3
    with pytest.raises(ValueError, match="microbatches"):
        _split("positions", pos, 3)


@pytest.mark.parametrize("n,micro", [(4, 2), (3, 3)])
def test_microbatched_step_equals_one_batch(n, micro):
    """The micro-batched step's loss and parameters equal the one-batch
    step's within 1e-4; with 2 micro-batches also the reference's
    micro-batched step (which reads any (3, ...) entry as M-RoPE ids, so
    a batch of three rows is left to the port)."""
    cfg = fu.cfg_of(ARCH)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = vlm_batch(cfg.d_model, 11, n, vocab=cfg.vocab)
    # the positions differ from row to row, so a misaligned cut shows
    batch["positions"] = batch["positions"] + np.arange(n)[None, :, None]
    out = {}
    for mb in (1, micro):
        _, _, pm = fu.pair(ARCH, seed=4)
        state = {"params": pm.params, "opt": fu.init_state(pm.params)}
        state, met = make_train_step(pm, AdamWConfig(**okw), loss_chunk=16,
                                     microbatches=mb)(state, batch)
        out[mb] = (met["loss"].item(), fu._flat(state["params"]))
    assert abs(out[micro][0] - out[1][0]) <= F32_BAND * out[1][0]
    for k, w in out[1][1].items():
        fu._close(out[micro][1][k], w, F32_BAND, k)
    if micro == 2:
        rm, rp, _ = fu.pair(ARCH, seed=4)
        step = jax.jit(rts.make_train_step(
            rm, fu.RefAdamW(**okw), loss_chunk=16, microbatches=2))
        _, rmet = step({"params": rp, "opt": fu.r_init_state(rp)},
                       _j(batch))
        assert abs(out[2][0] - float(rmet["loss"])) \
            <= F32_BAND * float(rmet["loss"])


# ------------------------------------------- the reference's smoke contract
def _smoke_batch(cfg, seed, labels=False):
    return vlm_batch(cfg.d_model, seed, positions=text_positions(S),
                     vocab=cfg.vocab if labels else None)


def test_forward_shapes_no_nan():
    cfg = reduce_cfg(configs.get_config(ARCH))
    m = build_model(cfg, "cpu", **fu.CHUNKS)
    m.init(0)
    logits = m.logits_seq(_smoke_batch(cfg, 0))
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


def test_train_step_decreases_loss():
    cfg = reduce_cfg(configs.get_config(ARCH))
    m = build_model(cfg, "cpu", **fu.CHUNKS)
    state = fu.init_train_state(m, 1)
    step = make_train_step(m, AdamWConfig(lr=3e-3, warmup_steps=2,
                                          total_steps=30), loss_chunk=16)
    batch = _smoke_batch(cfg, 1, labels=True)
    losses = []
    for _ in range(8):
        state, met = step(state, batch)
        losses.append(met["loss"].item())
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


# -------------------------------------------------------------- launchers
def test_launchers_refuse_the_vlm():
    with pytest.raises(NotImplementedError, match="embeds"):
        serve.main(["--mode", "lm", "--arch", ARCH, "--device", "cpu"])
    cfg = train.preset(configs.get_config(ARCH), "tiny")
    with pytest.raises(NotImplementedError, match="KeyError"):
        train.train(cfg, steps=1, batch=2, seq=16, device="cpu")
