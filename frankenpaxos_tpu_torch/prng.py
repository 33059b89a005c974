"""Threefry2x32 in PyTorch, bit for bit the stream of ``jax.random``.

In the batched simulator the random stream IS the simulated network: it
decides every message latency, every drop and every thrifty quorum. A
run of the port equals a run of the JAX package (same config, same
seed, same State after N ticks) only if both draw the same bits, so this
module reproduces jax's default PRNG exactly: ``threefry2x32`` with
``jax_threefry_partitionable=True`` (the setting of jax 0.9).

* A key is an explicit ``[2]`` int64 tensor on the CPU holding the two
  uint32 words of the jax key. Key derivation (``PRNGKey``, ``split``,
  ``fold_in``) runs on Python ints, so deriving a tick's keys costs no
  device launches.
* uint32 words are carried as masked int64: torch's uint32 lacks
  shifts, add and comparisons on the CPU. :func:`bits` therefore returns
  an int64 tensor whose values are jax's uint32 bits.
* :func:`bits` runs as plain torch ops on whatever device it is given,
  the card included. Fusing the sweep into the tick kernel is a later
  step (``ROADMAP.md``).

Counterparts in ``jax/_src/prng.py``: ``threefry_seed``,
``iota_2x32_shape``, ``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_fold_in`` and
``_threefry_random_bits_partitionable``; ``randint`` and ``uniform``
follow ``jax/_src/random.py:_randint`` and ``_uniform``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: int, k2: int, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 block cipher (20 rounds) on a counter pair.

    ``k1``/``k2`` are the key words as Python ints; ``x1``/``x2`` are
    Python ints or int64 tensors of uint32 values (any shape, any
    device). Every operation stays inside [0, 2**32)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def _key_words(key: torch.Tensor) -> Tuple[int, int]:
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed is taken as a
    32-bit integer, so the high word is 0 and the low word is the seed
    mod 2**32."""
    return _key(0, int(seed) & MASK32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair (0, data)."""
    k1, k2 = _key_words(key)
    y1, y2 = threefry2x32(k1, k2, 0, int(data) & MASK32)
    return _key(y1, y2)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (partitionable layout): key ``i``
    is threefry of the counter pair (0, i). Returns ``[num, 2]``."""
    k1, k2 = _key_words(key)
    rows = [threefry2x32(k1, k2, 0, i) for i in range(num)]
    return torch.tensor(rows, dtype=torch.int64).reshape(num, 2)


def bits(
    key: torch.Tensor, shape: Sequence[int], device=None
) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, partitionable layout) as
    an int64 tensor on ``device`` (default: the CPU): element ``n`` of
    the row-major flattening is ``b1 ^ b2`` of threefry at the counter
    pair (n >> 32, n & 0xFFFFFFFF)."""
    k1, k2 = _key_words(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return (b1 ^ b2).reshape(shape)


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    device=None,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for the default
    int32 dtype and scalar bounds: two 32-bit draws combined modulo the
    span, exactly as ``jax._src.random._randint`` does it."""
    minval = max(min(int(minval), 2**31 - 1), -(2**31))
    out_of_range = int(maxval) > 2**31 - 1
    maxval = max(min(int(maxval), 2**31 - 1), -(2**31))
    span = (maxval - minval) & MASK32
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK32
    k = split(key, 2)
    hi = bits(k[0], shape, device)
    lo = bits(k[1], shape, device)
    if span == 0:  # the full 2**32 range: the remainders are no-ops
        offset = (hi * 0 + lo) & MASK32
    else:
        mult = (2**16 % span) ** 2 % span
        offset = (((hi % span) * mult) & MASK32) + (lo % span)
        offset = (offset & MASK32) % span
    out = (minval + offset) & MASK32
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32)


def uniform(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
    device=None,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)``
    for float32, bit for bit, as ``jax._src.random._uniform`` does it:
    the top 23 bits of a 32-bit draw become the mantissa of a float in
    [1, 2), which is shifted to [0, 1), scaled by ``maxval - minval``,
    offset by ``minval`` and floored at ``minval``.

    XLA contracts the scale and the offset into one fused multiply-add,
    rounded once. Torch has no fused multiply-add, so the product is
    taken in float64, where it is exact (24 by 24 bits), and the sum is
    rounded once more to float32; where the float64 sum lies exactly
    halfway between two floats, it is stepped one float64 ulp towards
    the exact sum (its error, from TwoSum), so the tie goes the way the
    single rounding takes it. With the default bounds the scale and the
    offset are exact and this changes nothing."""
    shape = tuple(int(s) for s in shape)
    f32, f64 = torch.float32, torch.float64
    lo = torch.tensor(minval, dtype=f32, device=device)
    hi = torch.tensor(maxval, dtype=f32, device=device)
    mantissa = (bits(key, shape, device) >> 9) | 0x3F800000  # < 2**31
    floats = mantissa.to(torch.int32).view(f32) - 1.0
    prod = floats.to(f64) * (hi - lo).to(f64)
    lo64 = lo.to(f64)
    total = prod + lo64
    back = total - prod
    err = (prod - (total - back)) + (lo64 - back)
    tie = (total.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    toward = torch.where(err > 0, math.inf, -math.inf).to(f64)
    total = torch.where(tie & (err != 0), torch.nextafter(total, toward), total)
    return torch.maximum(lo, total.to(f32))
