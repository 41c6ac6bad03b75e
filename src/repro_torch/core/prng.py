"""The slice of ``jax.random`` the solver uses, in PyTorch.

Semantics are those of ``jax.random`` with the default ``threefry2x32``
implementation and ``jax_threefry_partitionable=True`` (the default since
jax 0.5), so a port fit walks the same key chain as the reference:

  * a key is a (2,) int64 tensor of uint32 words; a batch of keys is
    (..., 2);
  * ``PRNGKey(seed)`` = [seed >> 32, seed & 0xFFFFFFFF];
  * ``split(key, n)[i]`` = threefry2x32(key, (0, i)), both output words;
  * ``fold_in(key, d)`` = threefry2x32(key, (0, d));
  * ``random_bits(key, shape)`` at flat index i = x0 ^ x1 of
    threefry2x32(key, (i >> 32, i & 0xFFFFFFFF));
  * ``uniform`` sets the top 23 bits as the mantissa of a float in [1, 2)
    and subtracts 1; ``normal`` = sqrt(2) * erf_inv(uniform(-1 + ulp, 1));
  * ``truncated_normal`` = sqrt(2) * erf_inv(uniform(erf(lo / sqrt(2)),
    erf(hi / sqrt(2)))), clipped inside (lo, hi) (the LM initializers);
  * ``categorical`` = argmax(logits + gumbel), gumbel = -log(-log(
    uniform(tiny, 1))) (the LM sampler).

On the meta device every draw is shape-only: a key or bits tensor of the
right shape, with no hash evaluated (``models.model.param_shapes``).

Key words and uniforms are exact. ``erf_inv`` evaluates XLA's float32
polynomial (``ErfInv32``: w = -log1p(-x^2), two degree-8 Horner branches
split at w < 5), not ``torch.erfinv``, which is up to 64 ulp away from
it; each Horner step is rounded once, as XLA's fused multiply-add does.
The normals then agree with ``jax.random.normal`` to a few ulp (``log1p``
differs by an ulp between the two libraries).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.rng import MASK, _words, sqrt_rn, threefry2x32

_SQRT2 = float(np.float32(np.sqrt(2)))
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA ErfInv32 coefficients, highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_ERFINV_LT5 = tuple(float(np.float32(c)) for c in _ERFINV_LT5)
_ERFINV_GE5 = tuple(float(np.float32(c)) for c in _ERFINV_GE5)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The (2,) key of a non-negative integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The raw uint32 words of a key (keys are raw words here)."""
    return key


def _hash(key: torch.Tensor, c0, c1) -> torch.Tensor:
    """threefry2x32(key, (c0, c1)) stacked as (..., 2) keys; the key's
    batch dimensions lead, the counter's trail."""
    k0, k1 = key[..., 0], key[..., 1]
    shape = k0.shape
    c0 = _words(c0, key.device)
    c1 = _words(c1, key.device)
    if key.is_meta:
        return key.new_empty(shape + c1.shape + (2,))
    k0 = k0.reshape(shape + (1,) * c1.dim())
    k1 = k1.reshape(shape + (1,) * c1.dim())
    x0, x1 = threefry2x32(k0, k1, c0, c1)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., num, 2) new keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key, torch.zeros_like(i), i)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Key folded with ``data``: an int, or an int tensor of any shape,
    which gives a batch of keys of that shape (per-row keys)."""
    d = _words(data, key.device)
    return _hash(key, torch.zeros_like(d), d)


def _bits(key: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """(..., count) int64 uint32 words at flat indices [start, start +
    count)."""
    i = torch.arange(start, start + count, dtype=torch.int64,
                     device=key.device)
    words = _hash(key, i >> 32, i & MASK)
    return words[..., 0] ^ words[..., 1]


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(..., *shape) int64 tensor of uint32 words."""
    if key.is_meta:
        return key.new_empty(key.shape[:-1] + tuple(shape))
    n = int(np.prod(shape, dtype=np.int64))
    return _bits(key, 0, n).reshape(key.shape[:-1] + tuple(shape))


# (min, max) of the 32-bit integer dtypes ``randint`` draws.
_INT32_RANGE = {torch.int32: (-2 ** 31, 2 ** 31 - 1),
                torch.uint32: (0, 2 ** 32 - 1)}


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for words a, b in [0, 2^32), without an int64
    product that could overflow: a's two 16-bit halves go separately."""
    hi = ((a >> 16) * b) & MASK
    return ((hi << 16) + (a & 0xFFFF) * b) & MASK


def _rem32(a, span: int):
    """Unsigned a % span; XLA's unsigned remainder by 0 is a itself."""
    return a if span == 0 else a % span


def randint(key: torch.Tensor, shape: tuple, minval: int, maxval: int,
            dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Integers in [minval, maxval) as ``jax.random.randint`` draws them
    (32-bit dtypes): two draws of 32 bits from the key's split halves,
    the higher taken mod span times 2^32 mod span plus the lower mod span,
    all mod span, in uint32 arithmetic. ``minval`` and ``maxval`` are
    Python ints, clipped to the dtype's range as the reference clips
    them. A batch of keys (..., 2) gives (..., *shape)."""
    if dtype not in _INT32_RANGE:
        raise TypeError(f"randint draws int32 or uint32, got {dtype}")
    lo_d, hi_d = _INT32_RANGE[dtype]
    minval, maxval = int(minval), int(maxval)
    out_of_range = maxval > hi_d
    lo_v = min(max(minval, lo_d), hi_d)
    hi_v = min(max(maxval, lo_d), hi_d)
    span = (hi_v - lo_v) & MASK
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    if key.is_meta:
        return higher.to(dtype)
    mult = _rem32((_rem32(2 ** 16, span) ** 2) & MASK, span)
    offset = _rem32((_mulmod32(_rem32(higher, span), mult)
                     + _rem32(lower, span)) & MASK, span)
    words = (offset + (lo_v & MASK)) & MASK
    if dtype == torch.int32:
        return (words - ((words >> 31) << 32)).to(torch.int32)
    return words.to(torch.uint32)


def _uniform(bits: torch.Tensor, minval: float, maxval: float
             ) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(hi - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def uniform(key: torch.Tensor, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval)."""
    return _uniform(random_bits(key, shape), minval, maxval)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's ``ErfInv32`` polynomial."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0).double()
    # The coefficients are float32 values, so a float32 select of the two
    # scalars is exact; scalars travel as kernel arguments (a table copied
    # from the host would synchronize the host with the stream).
    coef = [torch.where(lt, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = (c.double() + p.double() * w).float()  # one rounding a step
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def normal(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """float32 standard normals, (..., *shape) for a (..., 2) key."""
    u = uniform(key, shape, _LO, 1.0)
    return _SQRT2 * erf_inv(u)


# Elements a truncated-normal draw makes at once: it bounds the draw's
# int64 and float64 temporaries (a (160, 5120, 1536) expert stack would
# need tens of GB of them at once); the values do not depend on it.
_DRAW_CHUNK = 1 << 26


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: tuple) -> torch.Tensor:
    """float32 normals truncated to (lower, upper), drawn as
    ``jax.random.truncated_normal`` draws them: uniforms between the
    float32 erf of the bounds over sqrt(2), mapped through sqrt(2)
    erf_inv, clipped to the next floats inside the bounds. Past
    ``_DRAW_CHUNK`` elements, made in parts (groups of a batch of keys,
    else ranges of the flat index)."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    if key.is_meta or n * (key.numel() // 2) <= _DRAW_CHUNK:
        return _truncated(random_bits(key, shape), lower, upper)
    if key.dim() > 1:
        flat = key.reshape(-1, 2)
        g = _DRAW_CHUNK // n
        parts = ([truncated_normal(k, lower, upper, shape)[None]
                  for k in flat] if g == 0 else
                 [truncated_normal(flat[i:i + g], lower, upper, shape)
                  for i in range(0, len(flat), g)])
        return torch.cat(parts).reshape(key.shape[:-1] + shape)
    parts = [_truncated(_bits(key, s, min(_DRAW_CHUNK, n - s)), lower,
                        upper) for s in range(0, n, _DRAW_CHUNK)]
    return torch.cat(parts).reshape(shape)


def _truncated(bits: torch.Tensor, lower: float, upper: float
               ) -> torch.Tensor:
    lo = torch.tensor(lower, dtype=torch.float32)
    hi = torch.tensor(upper, dtype=torch.float32)
    a = torch.erf(lo / _SQRT2).item()
    b = torch.erf(hi / _SQRT2).item()
    out = _SQRT2 * erf_inv(_uniform(bits, a, b))
    inf = torch.tensor(float("inf"))
    return out.clamp(torch.nextafter(lo, inf).item(),
                     torch.nextafter(hi, -inf).item())


def gumbel(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """float32 standard Gumbel draws, ``jax.random.gumbel``'s 'low' mode."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw a row from softmax(logits) over the last axis, by the
    Gumbel-max trick as ``jax.random.categorical`` (replace=True) draws
    it; int64 indices of logits' leading shape."""
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits, dim=-1)
