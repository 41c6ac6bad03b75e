"""The host-side layout of the Nystrom projection on the Gram engine, on
the CPU.

The projection phi = k(X, L) @ proj runs on csrc/gram_pipe.cuh's engine
with two operands copied 16 bytes at a time (CopyPair): the cross-Gram
chunk, stored landmark-major as an (m, R) scratch with rows R apart, and
proj, with its rows 16-byte aligned (``nystrom_phi.proj_operand`` pads a
copy where P % 4 != 0). What the wrapper hands the kernel is arithmetic
on shapes and pointers, so it is tested here without a card; the kernel
itself is held in tests/test_torch_kernels_gpu.py. The plain versions the
wrappers take on the CPU are held against the JAX package's reference
with the tolerance of tests/test_torch_nystrom.py: |d phi| <= 1e-5
(|k| @ |proj|) elementwise, scores through |W|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import nystrom_phi as nys
from repro_torch.kernels import ref

REL = 1e-5

# (N, m, P): phase 7 (rings, m = 1,000), phase 8 (alpha, m = 2,048),
# phase 10 (year, m = 681), and odd shapes: m % 32 != 0, P % 4 != 0, and
# P = 128 (with the bias column, a column tile holding only it).
SHAPES = [(1_000_000, 1000, 1000), (250_000, 2048, 2048),
          (463_715, 681, 681), (1037, 45, 45), (203, 100, 99),
          (300, 128, 128), (1, 7, 1), (70_001, 1023, 1023)]


@pytest.mark.parametrize("m,P", [(m, P) for _, m, P in SHAPES])
def test_proj_operand_has_a_16_byte_stride(m, P):
    proj = torch.from_numpy(np.random.default_rng(m).normal(
        size=(m, P)).astype(np.float32))
    got = nys.proj_operand(proj)
    ld = got.shape[1]
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape[0] == m and ld % nys.PROJ_ALIGN == 0
    assert P <= ld < P + nys.PROJ_ALIGN
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :P], proj)
    assert not torch.any(got[:, P:])
    # an aligned proj whose width is a multiple of 4 is not copied
    assert (got.data_ptr() == proj.data_ptr()) == (P % nys.PROJ_ALIGN == 0)


def test_proj_operand_copies_a_misaligned_proj():
    """A (m, 8) view starting one float into its storage has rows whose
    width is a multiple of 4 but an address that is not 16-byte aligned:
    the engine's 16-byte copies need a copy."""
    proj = torch.arange(41, dtype=torch.float32)[1:].view(5, 8)
    assert proj.data_ptr() % 16 != 0
    got = nys.proj_operand(proj)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, proj)


@pytest.mark.parametrize("add_bias", [False, True])
@pytest.mark.parametrize("N,m,P", SHAPES)
def test_phi_chunk_rows(N, m, P, add_bias):
    """nystrom_phi and nystrom_score: chunks of a multiple of 128 rows
    that cover N, whose (m, R) cross-Gram scratch fits SCRATCH_WORDS."""
    M = P + int(add_bias)
    R = nys._phi_chunk_rows(N, m, M)
    assert R % nys.GT == 0 and R % nys.PROJ_ALIGN == 0
    assert 0 < R <= -(-N // nys.GT) * nys.GT
    assert m * R <= nys.SCRATCH_WORDS and R * M <= nys.SCRATCH_WORDS


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("N,m,P", SHAPES)
def test_stats_chunk_keeps_the_scratch_aligned(N, m, P, sms):
    """nystrom_fused_stats: its chunk is the kc stride too, so it must be
    a multiple of 4 (the stats plan makes it whole 32-row splits)."""
    M = P + 1
    _, rows, R = nys.stats_plan(N, m, M, sms)
    assert rows % 32 == 0 and R % rows == 0 and R % nys.PROJ_ALIGN == 0
    assert m * R <= nys.SCRATCH_WORDS


@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("N,m,P", SHAPES)
def test_featurizer_scratch(N, m, P, kind):
    """The pointers and sizes the launchers receive: kc is (m, R) with
    rows R apart, proj goes as its aligned operand with ldp = its row
    stride, and the norms' scratch exists for the rbf kind only."""
    X = torch.zeros(3, 2)  # only its device, dtype and address are read
    L = torch.zeros(m, 2)
    proj = torch.ones(m, P)
    R = nys._phi_chunk_rows(N, m, P + 1)
    head, s, t = nys._featurizer_args(X, L, proj, None, N, 2, m, P, True,
                                      kind, 1.0, R)
    assert tuple(s["kc"].shape) == (m, R) and s["kc"].stride() == (R, 1)
    assert s["kc"].numel() <= nys.SCRATCH_WORDS
    assert s["kc"].data_ptr() % 16 == 0
    assert head[3] == s["proj"].data_ptr() and head[4] is None
    assert t["ldp"] == s["proj"].shape[1] == s["proj"].stride(0)
    assert t["ldp"] % nys.PROJ_ALIGN == 0 and t["P"] == P
    assert t["chunk"] == R and t["bias"] == 1
    assert s["sqx"].numel() == (N if kind == "rbf" else 0)
    assert s["sql"].numel() == (m if kind == "rbf" else 0)


# (N, D, m, P): m % 32 != 0 and P % 4 != 0; P = 128 with the bias column
# (M = 129); P < m.
PLAIN = [(37, 7, 45, 45), (61, 3, 130, 128), (50, 5, 33, 30)]


def _problem(N, D, m, P, seed=0):
    g = np.random.default_rng(seed)
    X = g.normal(size=(N, D)).astype(np.float32)
    L = X[g.choice(N, size=min(m, N), replace=False)]
    L = np.vstack([L, g.normal(size=(m - L.shape[0], D))]).astype(np.float32)
    proj = (0.2 * g.normal(size=(m, P))).astype(np.float32)
    mask = (g.uniform(size=N) > 0.2).astype(np.float32)
    d2 = ((X[:, None, :].astype(np.float64) - L[None].astype(np.float64))
          ** 2).sum(-1)
    return X, L, proj, mask, d2


@pytest.mark.parametrize("add_bias", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("shape", PLAIN)
def test_plain_phi_and_score_match_the_reference(shape, kind, add_bias):
    """The plain versions the wrappers run on the CPU, at the projection's
    odd shapes, against the JAX package's plain reference."""
    X, L, proj, mask, d2 = _problem(*shape)
    sigma = 1.3
    k64 = (np.exp(-d2 / (2.0 * sigma ** 2)) if kind == "rbf"
           else X.astype(np.float64) @ L.astype(np.float64).T)
    scale = np.abs(k64) @ np.abs(proj.astype(np.float64))
    if add_bias:
        scale = np.hstack([scale, np.ones((scale.shape[0], 1))])
    scale = scale * mask[:, None]
    t = [torch.from_numpy(a) for a in (X, L, proj, mask)]
    j = [jnp.asarray(a) for a in (X, L, proj, mask)]
    got = ref.nystrom_phi(*t, sigma, kind, add_bias).numpy()
    want = np.asarray(jops.nystrom_phi(*j, sigma=sigma, kind=kind,
                                       add_bias=add_bias, backend="ref"))
    assert got.shape == want.shape == (X.shape[0],
                                       proj.shape[1] + int(add_bias))
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= REL * scale), np.max(err - REL * scale)
    W = np.random.default_rng(3).normal(
        size=(got.shape[1], 3)).astype(np.float32)
    got = ref.nystrom_score(*t[:3], torch.from_numpy(W), t[3], sigma, kind,
                            add_bias).numpy()
    want = np.asarray(jops.nystrom_score(*j[:3], jnp.asarray(W), j[3],
                                         sigma=sigma, kind=kind,
                                         add_bias=add_bias, backend="ref"))
    err = np.abs(got.astype(np.float64) - want)
    lim = REL * (scale @ np.abs(W.astype(np.float64)))
    assert np.all(err <= lim), np.max(err - lim)
