"""DCD's whole sweep as one CUDA launch: every coordinate of every epoch
of the L1-loss dual coordinate descent baseline (``baselines/dcd.py``).

Replaces no Pallas kernel: the reference runs the sweep as one jitted
``lax.scan`` (``repro/baselines/dcd.py``, ``DCDSVM.fit``). Launched a
coordinate at a time from Python, the port would pay about six launches
a coordinate: 45 M launches for Table 5's 2.5 M rows x 3 epochs.

What bounds it on the H100: the chain of dependent coordinates (a dot
product, a butterfly sum, an IEEE division and two clamps, an axpy),
not bytes: the bytes bound, each row read once an epoch over 3.35 TB/s,
is about 1 ns a coordinate at K = 801. ``chip_smoke.py`` prints both.

Design (``csrc/dcd.cu``): one CTA, a producer warp and the chain. The
producer streams rows ``order[t + 1 ...]`` into a ring of shared-memory
stages with bulk copies on mbarriers, each the 16-byte aligned span that
covers the row (X is not padded). The chain keeps y_i, q_ii and alpha_i
of the next coordinates in its lanes, loaded a block of 32 coordinates
ahead; alpha, the one state that is read and written, is corrected from
the coordinates' own updates, which every lane forms. One chain warp
sums the dot with the xor butterfly, which leaves the sum in every lane,
so no barrier; several warps add one named barrier a coordinate over
double-buffered slots. ``plan`` picks the route by K: w and the row in
registers (one warp up to ``ONE_WARP_K`` columns, four up to ``REG_K``),
then w in shared memory (up to ``SMEM_W_FLOATS``), then in global
memory, the last two streaming the row in ``PIECE_FLOATS`` pieces.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build, ref

LAUNCHES = 0
# csrc/dcd.cu's constexprs (tests/test_torch_dcd_plan.py holds them equal).
SMEM_BYTES = 232_448       # shared memory a CTA may use
STATIC_BYTES = 1024        # the kernel's static shared memory, at most
MAX_DEPTH = 16             # ring stages
ONE_WARP_K = 1024          # K one chain warp keeps in registers
GROUP_WARPS = 4            # the chain's warps up to REG_K
REG_K = 4096               # K kept in registers
WIDE_WARPS = 8             # the chain's warps past REG_K
PIECE_FLOATS = 4096        # columns a ring stage carries past REG_K
SMEM_W_FLOATS = 32_768     # K whose w is kept in shared memory
LANE_FLOATS = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)
ROUTES = ("registers", "shared", "global")


@dataclasses.dataclass(frozen=True)
class Plan:
    """The sweep's launch: ``route`` (one of ROUTES), the chain's
    ``warps`` (the producer is one more), w's floats a lane holds on the
    registers route (a LANE_FLOATS bucket; 0 otherwise), the ring's
    ``depth`` stages of ``stage`` floats, and w's floats in shared memory
    (the shared route; 0 otherwise)."""
    route: str
    warps: int
    lane_floats: int
    stage: int
    depth: int
    smem_w: int = 0

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: the ring, then w on the shared route."""
        return 4 * (self.depth * self.stage + self.smem_w)


def plan(K: int, warps: int | None = None) -> Plan:
    """The launch for K columns. ``warps`` overrides the registers
    route's chain (1 or GROUP_WARPS), to time one layout against the
    other."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    budget = SMEM_BYTES - STATIC_BYTES
    if K <= REG_K:
        if warps is None:
            warps = 1 if K <= ONE_WARP_K else GROUP_WARPS
        need = -(-K // (32 * warps))
        fits = [b for b in LANE_FLOATS if b >= need]
        if warps not in (1, GROUP_WARPS) or not fits:
            raise ValueError(f"no registers-route kernel for K = {K} on "
                             f"{warps} warps")
        stage = (K + 6) // 4 * 4
        return Plan("registers", warps, fits[0], stage,
                    min(MAX_DEPTH, budget // (4 * stage)))
    stage = PIECE_FLOATS + 4
    if K <= SMEM_W_FLOATS:
        depth = min(MAX_DEPTH, (budget - 4 * K) // (4 * stage))
        return Plan("shared", WIDE_WARPS, 0, stage, depth, smem_w=K)
    return Plan("global", WIDE_WARPS, 0, stage,
                min(MAX_DEPTH, budget // (4 * stage)))


def dcd_sweep(X: torch.Tensor, y: torch.Tensor, qdiag: torch.Tensor,
              order: torch.Tensor, C: float):
    """(w (K,), alpha (N,)) of the dual coordinate descent over the rows
    ``order`` names (int32, every epoch's permutation in turn), from
    w = 0 and alpha = 0. X (N, K) float32, y and qdiag (N,) float32. A
    CPU tensor runs the plain version."""
    global LAUNCHES
    if X.device.type == "cpu":
        return ref.dcd_sweep(X, y, qdiag, order, C)
    N, K = _build.check_x(X)
    if X.dtype != torch.float32:
        raise TypeError(f"dcd_sweep takes float32 X, got {X.dtype}")
    _build.check_vec("y", y, N, X)
    _build.check_vec("qdiag", qdiag, N, X)
    if order.device != X.device or order.dtype != torch.int32 \
            or order.dim() != 1 or not order.is_contiguous():
        raise ValueError("order must be a contiguous int32 vector on X's "
                         "device")
    if order.numel():
        lo, hi = (int(v) for v in torch.aminmax(order))
        if lo < 0 or hi >= N:
            raise ValueError(f"order names rows {lo}..{hi}, X has {N}")
    p = plan(K)
    w = torch.empty(K, dtype=torch.float32, device=X.device)
    alpha = torch.zeros(N, dtype=torch.float32, device=X.device)
    _build.launch("rt_dcd_sweep", X.device, X.data_ptr(), y.data_ptr(),
                  qdiag.data_ptr(), order.data_ptr(), order.numel(),
                  float(C), K, w.data_ptr(), alpha.data_ptr(),
                  ROUTES.index(p.route), p.warps, p.lane_floats, p.stage,
                  p.depth)
    LAUNCHES += 1
    return w, alpha
