"""The launch plan of the Hopper fused_estep, on the CPU.

``csrc/fused_estep.cu`` gives each warp a contiguous range of rows; a lane
holds VALUES values of a row, so a row of up to SEG = 32 VALUES columns
stays in registers and X is read once, and wider rows go in SEG-wide
column segments. What the wrapper hands the kernel (CTAs, rows a warp,
the loads' width, the b partials' size) is arithmetic on shapes and
pointers, so it is tested here without a card; the kernel itself is held
in tests/test_torch_kernels_gpu.py. The plain version the wrapper takes on
the CPU is held against the JAX package's reference at the route's widths
with the tolerance of tests/test_torch_kernels_ref.py (well-conditioned
regime: |d| <= 1e-5 (1 + |v|) for margin and gamma, 1e-5 max|ref| for b).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fused_estep as fe

# (N, K): phase 5 (131,072 x 2,048), phase 8's E-step (250,000 x 2,049),
# rows past the register-resident width (two and three segments), and
# small N (fewer rows than a wave of warps; N % 4 != 0).
PLANS = [(131_072, 2048), (250_000, 2049), (4099, 4100), (1031, 6600),
         (1, 2048), (7, 1537), (31, 2049), (517, 29)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("N,K", PLANS)
def test_plan_covers_the_rows_once(N, K, sms):
    """One wave at most (CTAS_PER_SM an SM), every CTA with rows, the
    warps' consecutive ranges covering [0, N) once."""
    p = fe.estep_plan(N, K, sms)
    ctas, rows = p["ctas"], p["rows_per_warp"]
    assert 1 <= ctas <= fe.CTAS_PER_SM * sms and rows >= 1
    warps = ctas * fe.WARPS
    assert (ctas - 1) * fe.WARPS * rows < N <= warps * rows
    cover = np.zeros(N, dtype=np.int64)
    for w in range(warps):
        cover[w * rows:min(N, (w + 1) * rows)] += 1
    assert np.all(cover == 1)
    assert p["partial_words"] == ctas * K


@pytest.mark.parametrize("N,K", PLANS)
def test_plan_segments(N, K):
    """Rows up to SEG columns are held whole (phase 5's and phase 8's
    widths among them); wider rows take ceil(K / SEG) segments."""
    p = fe.estep_plan(N, K, 132)
    assert fe.SEG == 32 * fe.VALUES and fe.VALUES % 4 == 0
    assert p["segments"] == -(-K // fe.SEG)
    assert (p["segments"] == 1) == (K <= fe.SEG)
    if K in (2048, 2049):
        assert p["segments"] == 1


def test_plan_at_the_main_path_shapes():
    """Phase 5 and phase 8 on 132 SMs: 395 and 396 CTAs of 4 warps in one
    wave (of 396), 83 and 158 rows a warp; 31 rows: 8 CTAs, a row a
    warp."""
    assert fe.estep_plan(131_072, 2048, 132) == dict(
        ctas=395, rows_per_warp=83, segments=1, partial_words=395 * 2048)
    assert fe.estep_plan(250_000, 2049, 132) == dict(
        ctas=396, rows_per_warp=158, segments=1, partial_words=396 * 2049)
    assert fe.estep_plan(31, 2049, 132)["ctas"] == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [2048, 2049, 4100, 29, 300, 1537])
def test_vec16_by_width_and_alignment(K, dtype):
    """A lane's four columns are one load where K % 4 == 0 and X is
    aligned to four elements (16 bytes of float32, 8 of bfloat16); else
    four element loads."""
    X = torch.zeros((3, K), dtype=dtype)
    assert X.data_ptr() % 16 == 0
    assert fe.estep_vec16(X) == (K % 4 == 0)
    buf = torch.zeros(3 * K + 4, dtype=dtype)
    assert not fe.estep_vec16(buf[1:1 + 3 * K].view(3, K))
    assert fe.estep_vec16(buf[4:4 + 3 * K].view(3, K)) == (K % 4 == 0)


@pytest.mark.parametrize("N,K", [(37, 1537), (13, 2049), (9, 2300)])
def test_plain_estep_matches_the_reference(N, K):
    """The plain version at the K > 1536 route's widths against the JAX
    package's plain reference, well-conditioned regime."""
    g = np.random.default_rng(K)
    X = g.normal(size=(N, K)).astype(np.float32)
    w = (g.normal(size=K) / np.sqrt(K)).astype(np.float32)
    m64 = X.astype(np.float64) @ w.astype(np.float64)
    rho = (m64 + g.uniform(0.05, 2.0, N) * g.choice([-1.0, 1.0], N)
           ).astype(np.float32)
    beta = g.normal(size=N).astype(np.float32)
    got = fe.fused_estep(*(torch.from_numpy(a) for a in (X, rho, beta, w)),
                         eps=1e-6)
    want = jops.fused_estep(*(jnp.asarray(a) for a in (X, rho, beta, w)),
                            eps=1e-6, backend="ref")
    for a, b in zip(got[:2], want[:2]):
        b = np.asarray(b, dtype=np.float64)
        assert np.all(np.abs(a.numpy() - b) <= 1e-5 * (1 + np.abs(b)))
    b = np.asarray(want[2], dtype=np.float64)
    assert np.max(np.abs(got[2].numpy() - b)) <= 1e-5 * np.max(np.abs(b))
