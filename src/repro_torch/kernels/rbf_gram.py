"""RBF Gram blocks on Hopper: K_ij = exp(-||x1_i - x2_j||^2 / 2 sigma^2).

Replaces the TPU kernel ``repro/kernels/rbf_gram.py::rbf_gram`` (a grid
of (b1, b2) tiles whose body, ``rbf_tile``, expands the distance as
|x1|^2 - 2 x1.x2 + |x2|^2 so the inner product runs on the MXU).

What bounds it on the H100: at the landmark Gram of the Nystrom fit,
(1,000 x 2)^2, nothing but launch latency; at (2,048 x 500)^2 the
2 N1 N2 D flop of the inner products against 4 (N1 + N2) D + 4 N1 N2
bytes, about 125 flop per byte: fp32 operations, above the ridge of ~20.

Design (``csrc/rbf_gram.cu``, tile body in ``csrc/rbf.cuh``, shared with
every Nystrom kernel so the featurizer and the Gram cannot drift apart):
one launch computes the squared norms, a warp a row; a second computes
128 x 128 output tiles, 256 threads with 8 x 8 register accumulators,
staging 32-deep slices of both operands in shared memory, and applies
the transform exp(-max(d2, 0) * inv_two_sigma_sq) in registers before
the one store of each entry. Each transform operation is rounded on its
own (no FMA contraction) and the exponential is the IEEE-mode ``expf``.
"""
from __future__ import annotations

import torch

from . import _build, ref

LAUNCHES = 0


def rbf_gram(X1: torch.Tensor, X2: torch.Tensor, *, sigma: float = 1.0
             ) -> torch.Tensor:
    """(N1, N2) float32. X1 (N1, D), X2 (N2, D) float32 or bfloat16 (a
    bfloat16 X2 needs a bfloat16 X1). A CPU tensor runs the plain
    version."""
    global LAUNCHES
    if X1.device.type == "cpu":
        return ref.rbf_gram(X1, X2, float(sigma))
    N1, D = _build.check_x(X1)
    N2, D2 = _build.check_x(X2)
    if D2 != D or X2.device != X1.device:
        raise ValueError(f"X2 must be (N2, {D}) on {X1.device}, got "
                         f"{tuple(X2.shape)} on {X2.device}")
    if X1.dtype == torch.float32 and X2.dtype == torch.bfloat16:
        raise TypeError("rbf_gram takes a bfloat16 X2 only with a "
                        "bfloat16 X1")
    f32 = dict(dtype=torch.float32, device=X1.device)
    sq1, sq2 = torch.empty(N1, **f32), torch.empty(N2, **f32)
    out = torch.empty((N1, N2), **f32)
    _build.launch("rt_rbf_gram", X1.device, X1.data_ptr(),
                  int(X1.dtype == torch.bfloat16), X2.data_ptr(),
                  int(X2.dtype == torch.bfloat16), sq1.data_ptr(),
                  sq2.data_ptr(), out.data_ptr(), N1, N2, D,
                  1.0 / (2.0 * float(sigma) ** 2))
    LAUNCHES += 1
    return out
