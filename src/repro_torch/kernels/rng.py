"""Counter-based RNG for the Gibbs noise: port of ``repro/kernels/rng.py``.

The MC epilogue needs, per row and chain, a standard normal ``nu`` and a
uniform ``u``. Under rng mode 'fused' they are derived from a stateless
counter cipher instead of being pre-drawn:

    bits = threefry2x32(k0, k1, c0 = global_row, c1 = chain * 4 + word)

``(k0, k1)`` are the words of the iteration's key. The CUDA kernel
(``csrc/rng.cuh``) runs the same cipher on native ``uint32_t``; this module
is the host side, the plain version the kernel is held against and the
materialized stream of rng mode 'fused_predraw'.

PyTorch on the CPU has no uint32 add or shift, so the words are int64
tensors holding values in [0, 2^32), masked back after every add and left
shift. The words equal the reference's exactly. The floats go through one
``log``, ``sqrt`` and ``cos`` joined by bare multiplies (Box-Muller, no
``a*b + c`` for a compiler to contract); across frameworks those
primitives differ by an ulp, so the normals agree to a few ulp.

A seed is a (4,) int64 tensor of the words ``[k0, k1, row0, chain0]``,
on the device of the kernel that reads it (no host sync to launch).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
# Threefry-2x32, 20 rounds: 5 groups of 4 with alternating rotation
# schedules and a key injection after each group.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# The float32 constants of the reference, rounded once.
TWO_PI = float(np.float32(6.283185307179586))
_HALF = 0.5
_TWO_M23 = 2.0 ** -23


def _words(x, device=None) -> torch.Tensor:
    """An int or int tensor as int64 words in [0, 2^32). A Python int is
    filled on the device (a kernel argument), not copied from the host:
    a copy from pageable memory would synchronize the host with the
    stream, once a chunk in the stream driver."""
    if isinstance(x, int):
        x = torch.full((), x, dtype=torch.int64, device=device)
    elif not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in x's dtype. PyTorch's float32
    ``sqrt`` on the CPU is not (on a share of inputs it differs from
    IEEE, numpy and XLA); a float64 sqrt rounded once to float32 is."""
    if x.dtype == torch.float64:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 block cipher (20 rounds) on int64 words. Key and
    counter words broadcast together; returns the two output words."""
    dev = next((t.device for t in (k0, k1, c0, c1)
                if isinstance(t, torch.Tensor)), None)
    k0, k1, c0, c1 = (_words(t, dev) for t in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for i in range(5):
        for d in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = x0 ^ _rotl(x1, d)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Words -> float32 uniform (i + 0.5) * 2^-23 from the top 23 bits:
    strictly inside (0, 1), so the Box-Muller log stays finite."""
    i = (bits >> 9).to(torch.float32)
    return (i + _HALF) * _TWO_M23


def normal_from_bits(bits0: torch.Tensor, bits1: torch.Tensor
                     ) -> torch.Tensor:
    """Two words -> one float32 standard normal by Box-Muller:
    sqrt(-2 ln u1) * cos(2 pi u2)."""
    r = sqrt_rn(-2.0 * torch.log(uniform_from_bits(bits0)))
    return r * torch.cos(TWO_PI * uniform_from_bits(bits1))


def counter_noise(k0, k1, rows, chains, n_noise: int):
    """The (nu, u[, nu_o, u_o]) tuple at the given row and chain
    coordinates (int tensors or ints, broadcast together). Mixture m uses
    counter words c1 = chain*4 + 2m (both output words feed the normal)
    and c1 = chain*4 + 2m + 1 (word 0 is the accept-reject uniform)."""
    assert n_noise in (2, 4), n_noise
    dev = next((t.device for t in (k0, k1, rows, chains)
                if isinstance(t, torch.Tensor)), None)
    rows = _words(rows, dev)
    chains = _words(chains, dev)
    out = []
    for m in range(n_noise // 2):
        base = ((chains << 2) & MASK) | (2 * m)
        n0, n1 = threefry2x32(k0, k1, rows, base)
        u0, _ = threefry2x32(k0, k1, rows, base | 1)
        out.append(normal_from_bits(n0, n1))
        out.append(uniform_from_bits(u0))
    return tuple(out)


def key_words(key: torch.Tensor):
    """The (k0, k1) words of a (..., 2) key tensor."""
    return key[..., 0], key[..., 1]


def pack_seed(key: torch.Tensor, row0=0, chain0=0) -> torch.Tensor:
    """(4,) int64 seed [k0, k1, row0, chain0] on the key's device; the
    offsets are non-negative 31-bit integers, as in the reference."""
    k0, k1 = key_words(_words(key))
    dev = key.device
    return torch.stack([k0, k1, _words(row0, dev).reshape(()),
                        _words(chain0, dev).reshape(())])


def draw_fused_noise(key: torch.Tensor, n: int, row0=0, chain=0,
                     n_noise: int = 2):
    """Host materialization of the counter stream: ``n_noise`` (n,)
    tensors, exactly the words (and, to a few ulp, the floats) the fused
    kernel derives in-body for rows [row0, row0 + n) of ``chain``."""
    k0, k1 = key_words(_words(key))
    rows = _words(row0, key.device) + torch.arange(
        n, dtype=torch.int64, device=key.device)
    return counter_noise(k0, k1, rows, chain, n_noise)
