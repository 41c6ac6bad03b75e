"""The port's xLSTM (``models/xlstm.py``: ``init_mlstm``,
``_mlstm_heads``, the chunkwise ``mlstm_seq``, ``mlstm_decode``,
``mlstm_prefill``; ``init_slstm``, ``_slstm_cell``, ``slstm_seq``,
``slstm_decode``, ``slstm_prefill``; the xLSTM blocks of
``models/transformer``; ``Model`` with ``family == "ssm"``) against the
JAX package on the CPU, at the reduced xlstm-350m (``conftest.reduce_cfg``:
12 layers, two periods of 5 mLSTM + 1 sLSTM block, d 64, 4 heads of
d_inner / 4 = 32), B = 2, S = 32, ``ssm_chunk`` 8, on numpy-seeded
inputs.

Bands, fixed before the first comparison:

* ``init(seed)``: the leaves drawn by exact ops (ones, zeros, constants:
  ``b_if``, ``b_gates``, the norms) bitwise, the others within 1e-6 of
  max|leaf| (the truncated normal's ``erf_inv`` and ``log1p`` differ by
  an ulp between the libraries);
* ``mlstm_seq`` (several chunks, and one chunk at a length that divides
  nothing) and ``slstm_seq``: within 1e-5 of max|ref| in float32;
* float32: hidden states, logits, prefill logits and every state leaf
  (mLSTM's C, n, m; sLSTM's c, n, h, m), two decode steps' logits and
  states, within 1e-4 of max|ref|;
* bfloat16, block by block (``check_blocks_bfloat16``, one period: every
  block kind): every block given the reference's own input and state to
  it, its prefill output and state and two decode steps through the
  serving copy, and the logits from the reference's last hidden state,
  within 3e-2 of max|ref|. The
  whole bfloat16 stack is not compared end to end: at two periods of
  random-init blocks the reference's own bfloat16 stack lands 0.13-0.24
  of max|ref| from its float32 stack and 0.10 from its jitted self;
* teacher forcing (prefill then decode against the full sequence):
  within 1e-4 of max|ref| in float32, rtol = atol = 2e-2 in bfloat16
  (tests/test_models_smoke.py);
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
from repro.models import transformer as rtfm
from repro.models import xlstm as rxl
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import xlstm

ARCH = "xlstm-350m"
F32_BAND, BF16_BAND, INIT_BAND, MIXER_BAND = 1e-4, 3e-2, 1e-6, 1e-5
TOTAL = 506_086_560        # jax.eval_shape of the reference's init
# the leaves the reference reads in float32 (repro/models/xlstm.py: b_if
# :55, r_gates and b_gates :187-188)
FLOAT32_LEAVES = {"b_if", "r_gates", "b_gates"}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -------------------------------------------------------------------- init
def test_init_matches_reference_leaf_by_leaf():
    names = fu.check_init(ARCH, {"b_if", "b_gates"}, INIT_BAND)
    assert any(n.endswith("/mlstm/b_if") for n in names)
    assert any(n.endswith("/slstm/r_gates") for n in names)
    assert not any("/norm2" in n or "/ffn/" in n for n in names)


def test_full_config_shapes_match_reference():
    cfg = fu.check_full_shapes(ARCH, TOTAL)
    assert cfg.num_params() == 312_787_968 != TOTAL
    shapes = fu.param_shapes(configs.get_config(ARCH))
    # mLSTM's head width is d_inner / n_heads = 512, not head_dim 256
    assert shapes["layers/pos0/mlstm/wq"] == (4, 2048, 2048)
    assert shapes["layers/pos5/slstm/r_gates"] == (4, 4, 256, 1024)


# ------------------------------------------------------------------ mixers
@pytest.mark.parametrize("S,chunk", [(32, 8), (13, 8)])
def test_mlstm_seq_matches_reference(S, chunk):
    rm, rp, _ = fu.pair(ARCH)
    p, port = fu.layer(rp, "pos0", "mlstm")
    x = _x((fu.B, S, rm.cfg.d_model), seed=S)
    want = rxl.mlstm_seq(rm.cfg, p, jnp.asarray(x), chunk=chunk)
    got = xlstm.mlstm_seq(rm.cfg, port, torch.from_numpy(x), chunk=chunk)
    assert fu.rel(got.numpy(), np.asarray(want)) <= MIXER_BAND


def test_slstm_seq_matches_reference():
    rm, rp, _ = fu.pair(ARCH)
    p, port = fu.layer(rp, "pos5", "slstm")
    x = _x((fu.B, fu.S, rm.cfg.d_model), seed=3)
    want = rxl.slstm_seq(rm.cfg, p, jnp.asarray(x))
    got = xlstm.slstm_seq(rm.cfg, port, torch.from_numpy(x))
    assert fu.rel(got.numpy(), np.asarray(want)) <= MIXER_BAND


def test_initial_states_match_reference():
    cfg = fu.cfg_of(ARCH)
    for mine, ref in ((xlstm.mlstm_init_state(cfg, 3),
                       rxl.mlstm_init_state(cfg, 3)),
                      (xlstm.slstm_init_state(cfg, 3),
                       rxl.slstm_init_state(cfg, 3))):
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert mine[k].dtype == torch.float32
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))


def test_prefill_states_match_reference():
    rm, rp, _ = fu.pair(ARCH)
    x = _x((fu.B, fu.S, rm.cfg.d_model), seed=4)
    for pos, name, rfn, pfn in (
            ("pos0", "mlstm", lambda c, p, h: rtfm._mlstm_prefill(c, p, h, 8),
             lambda c, p, h: xlstm.mlstm_prefill(c, p, h, 8)),
            ("pos5", "slstm", rtfm._slstm_prefill, xlstm.slstm_prefill)):
        p, port = fu.layer(rp, pos, name)
        out_r, st_r = rfn(rm.cfg, p, jnp.asarray(x))
        out_p, st_p = pfn(rm.cfg, port, torch.from_numpy(x))
        assert fu.rel(out_p.numpy(), np.asarray(out_r)) <= MIXER_BAND
        for k in st_r:
            assert fu.rel(st_p[k].numpy(), np.asarray(st_r[k])) <= F32_BAND


# ---------------------------------------------------------------- decoder
def test_hidden_and_logits_match_reference():
    fu.check_hidden_and_logits(ARCH, F32_BAND)


def test_prefill_states_and_decode_match_reference():
    fu.check_prefill_and_decode(ARCH, F32_BAND)


def test_blocks_match_reference_in_bfloat16():
    # one period has every block kind, each fed the reference's own input
    d = fu.check_blocks_bfloat16(ARCH, BF16_BAND, n_layers=6)
    print(f"largest distance {d:.3e}")


def test_serving_copy_keeps_the_float32_leaves():
    fu.check_float32_leaves(ARCH, FLOAT32_LEAVES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_full_sequence(dtype):
    d, _ = fu.teacher_forcing(ARCH, dtype)
    print(f"teacher forcing ({dtype}): {d:.3e} of max|ref|")
    if dtype == "float32":
        assert d <= F32_BAND


# --------------------------------------------------------------- training
def test_train_step_matches_reference():
    names = fu.check_train_step(ARCH, F32_BAND)
    assert any("/slstm/r_gates" in n for n in names)


def test_remat_policies_are_bitwise_equal():
    fu.check_remat_bitwise(ARCH)


def test_train_snapshots_cross_packages(tmp_path):
    names = fu.check_snapshot_crossing(ARCH, tmp_path)
    assert any(n.startswith("opt/v/layers/pos5/slstm") for n in names)


def test_serve_cli_xlstm(capsys):
    assert serve.main(["--mode", "lm", "--arch", ARCH, "--preset", "tiny",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "16", "--steps", "4"]) == 0
    assert "generated (2, 4) tokens" in capsys.readouterr().out
