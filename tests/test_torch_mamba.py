"""The port's Mamba hybrid (``models/mamba.py``: ``init_mamba``,
``_ssm_params``, ``_scan_chunk``'s associative scan, ``mamba_seq``,
``mamba_decode``, ``mamba_prefill``; the hybrid blocks of
``models/transformer``; ``Model`` with ``family == "hybrid"``) against
the JAX package on the CPU, at the reduced jamba-v0.1-52b
(``conftest.reduce_cfg``: 16 layers, two periods of 7 Mamba + 1 attention
block, 4 experts top-2 every second layer), B = 2, S = 32, ``ssm_chunk``
8, on numpy-seeded inputs.

Bands, fixed before the first comparison:

* ``init(seed)``: the leaves drawn by exact ops (ones, zeros) bitwise,
  the others within 1e-6 of max|leaf| (the truncated normal's
  ``erf_inv`` and ``log1p``, ``log`` / ``exp`` / ``expm1`` of the dt
  bias and ``log`` of A differ by an ulp between the libraries);
* the associative scan, ``_scan_chunk`` (at chunk lengths that are not
  powers of two) and ``mamba_seq``: within 1e-5 of max|ref| in float32;
* float32: hidden states, logits, prefill logits and every state leaf
  (h, the conv window, the attention block's K / V), two decode steps'
  logits and states, within 1e-4 of max|ref|;
* bfloat16, block by block (``check_blocks_bfloat16``, one period: every
  block kind): every block, given the reference's own input, cache and
  expert ids (the reference run eagerly, recording them), its prefill
  output and state and its two decode steps' outputs and states through
  the serving copy, and the logits from the reference's last hidden
  state, within 3e-2 of max|ref|. The whole bfloat16 stack is not compared end
  to end: at two periods of random-init layers the reference's own
  bfloat16 stack lands 0.05-0.79 of max|ref| from its float32 stack and
  0.05-0.22 from its jitted self (the rounding grows through the Mamba
  blocks, and flips MoE routes at near-ties), so no band holds there;
* teacher forcing (prefill then decode against the full sequence) at a
  capacity factor that drops nothing: in float32 within 1e-4 of max|ref|
  at two periods; in bfloat16 rtol = atol = 2e-2
  (tests/test_models_smoke.py) at one period, with the full pass's routes
  replayed: at two periods the reference's own bfloat16 teacher forcing
  misses that band at 3 of 6 seeds (0.025-0.48 of max|ref|);
* one train step: loss within 1e-4 relative, parameters with rtol 1e-3,
  atol 1.5 x 2 lr (tests/test_training.py); remat off, 'nothing' and
  'dots' bitwise equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_util as fu
from torch_family_util import one_torch_thread  # noqa: F401
from repro.models import mamba as rmb
from repro_torch import configs
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, mamba

ARCH = "jamba-v0.1-52b"
F32_BAND, BF16_BAND, INIT_BAND, MIXER_BAND = 1e-4, 3e-2, 1e-6, 1e-5
TOTAL = 51_570_315_264     # jax.eval_shape of the reference's init
# the leaves the reference reads in float32 (repro/models/mamba.py: a_log
# :89 and :138; conv_w, conv_bias and d_skip in mamba_decode :133, :134,
# :144) and the MoE router (mlp.py's _route)
FLOAT32_LEAVES = {"a_log", "conv_w", "conv_bias", "d_skip", "router"}


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


# -------------------------------------------------------------------- init
def test_init_matches_reference_leaf_by_leaf():
    names = fu.check_init(ARCH, {"conv_bias", "d_skip"}, INIT_BAND)
    assert any(n.endswith("/mamba/a_log") for n in names)
    assert any(n.endswith("/attn/wq") for n in names)
    assert any(n.endswith("/moe/router") for n in names)


def test_full_config_shapes_match_reference():
    cfg = fu.check_full_shapes(ARCH, TOTAL)
    assert cfg.num_params() != TOTAL     # the analytic count differs
    shapes = fu.param_shapes(configs.get_config(ARCH))
    assert shapes["layers/pos0/mamba/a_log"] == (4, 8192, 16)
    assert shapes["layers/pos0/mamba/x_proj"] == (4, 8192, 256 + 32)


# ------------------------------------------------------------------ mixer
@pytest.mark.parametrize("n", [1, 2, 7, 12, 13])
def test_associative_scan_matches_lax(n):
    a, b = _x((2, n, 3, 4), seed=n), _x((2, n, 3, 4), seed=n + 1)
    a = np.exp(-np.abs(a))
    want = jax.lax.associative_scan(
        lambda p, q: (p[0] * q[0], q[0] * p[1] + q[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = mamba.associative_scan(mamba._affine, (torch.from_numpy(a),
                                                 torch.from_numpy(b)), 1)
    for g, w in zip(got, want):
        assert fu.rel(g.numpy(), np.asarray(w)) <= MIXER_BAND


@pytest.mark.parametrize("C", [12, 16])
def test_scan_chunk_matches_reference(C):
    cfg = fu.cfg_of(ARCH)
    di, ds = cfg.d_inner, cfg.mamba_d_state
    A = np.exp(_x((di, ds), seed=2, scale=0.5))
    dt = np.log1p(np.exp(_x((fu.B, C, di), seed=3)))
    Bm, Cm = _x((fu.B, C, ds), seed=4), _x((fu.B, C, ds), seed=5)
    xc, h0 = _x((fu.B, C, di), seed=6), _x((fu.B, di, ds), seed=7)
    yr, hr = rmb._scan_chunk(*map(jnp.asarray, (A, dt, Bm, Cm, xc, h0)))
    yp, hp = mamba._scan_chunk(*map(torch.from_numpy,
                                    (A, dt, Bm, Cm, xc, h0)))
    assert fu.rel(yp.numpy(), np.asarray(yr)) <= MIXER_BAND
    assert fu.rel(hp.numpy(), np.asarray(hr)) <= MIXER_BAND


@pytest.mark.parametrize("S,chunk", [(32, 8), (13, 8)])
def test_mamba_seq_matches_reference(S, chunk):
    rm, rp, _ = fu.pair(ARCH)
    cfg = rm.cfg
    p, port = fu.layer(rp, "pos0", "mamba")
    x = _x((fu.B, S, cfg.d_model), seed=S)
    want = rmb.mamba_seq(cfg, p, jnp.asarray(x), chunk=chunk)
    got = mamba.mamba_seq(cfg, port, torch.from_numpy(x), chunk=chunk)
    assert fu.rel(got.numpy(), np.asarray(want)) <= MIXER_BAND


# ---------------------------------------------------------------- decoder
def test_hidden_and_logits_match_reference():
    fu.check_hidden_and_logits(ARCH, F32_BAND)


def test_prefill_states_and_decode_match_reference():
    fu.check_prefill_and_decode(ARCH, F32_BAND)


def test_blocks_match_reference_in_bfloat16():
    # one period has every block kind, each fed the reference's own input
    d = fu.check_blocks_bfloat16(ARCH, BF16_BAND, n_layers=8)
    print(f"largest distance {d:.3e}")


def test_serving_copy_keeps_the_float32_leaves():
    fu.check_float32_leaves(ARCH, FLOAT32_LEAVES)


def test_cast_at_use_serves_the_cast_copys_bits():
    """``cast_at_use`` (no cast copy held) gives the cast copy's bits."""
    cfg = fu.cfg_of(ARCH, "bfloat16")
    toks = fu.tokens(cfg.vocab, (fu.B, fu.S + 1))
    out = []
    for at_use in (False, True):
        m = build_model(configs.ModelConfig(**dataclasses.asdict(cfg)),
                        "cpu", cast_at_use=at_use, **fu.CHUNKS)
        m.init(1)
        lg, caches = m.prefill({"tokens": toks[:, :fu.S]}, fu.S + 4)
        d, _ = m.decode(toks[:, fu.S:], fu.S, caches)
        out.append((lg, d, m.hidden_seq({"tokens": toks})))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_full_sequence(dtype):
    kw = {} if dtype == "float32" else {"n_layers": 8}
    held, free = fu.teacher_forcing(ARCH, dtype, **kw)
    print(f"teacher forcing ({dtype}): {held:.3e} of max|ref|, each run "
          f"routing for itself {free:.3e}")
    if dtype == "float32":
        assert held <= F32_BAND


# --------------------------------------------------------------- training
def test_train_step_matches_reference():
    names = fu.check_train_step(ARCH, F32_BAND)
    assert any("/mamba/a_log" in n for n in names)


def test_remat_policies_are_bitwise_equal():
    fu.check_remat_bitwise(ARCH)


def test_train_snapshots_cross_packages(tmp_path):
    names = fu.check_snapshot_crossing(ARCH, tmp_path)
    assert "opt/step" in names


def test_train_cli_jamba(capsys):
    assert train_cli.main(["--arch", ARCH, "--preset", "tiny", "--device",
                           "cpu", "--steps", "2", "--batch", "2", "--seq",
                           "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert out["monitor"]["steps"] == 2
