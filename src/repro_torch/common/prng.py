"""The threefry2x32 counter-based PRNG on torch tensors, bit-exact with
the stream JAX draws by default (``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True``): the port's copy of what the
reference's sampler (``repro.serving.sampler``) takes from
``jax.random``.

A key is two 32-bit words; here a batch of keys is an int64 tensor
[B, 2] whose words lie in [0, 2**32).  Every word stays in int64,
masked back to 32 bits after each add and shift, so the arithmetic is
exact on any device and needs no unsigned 32-bit ops (few of which
torch has on CUDA; ``>>`` on int32 is arithmetic).  Each function
draws for every row of the batch at once, on the keys' device.

  prng_key(seed)           -- ``jax.random.PRNGKey`` of 32-bit seeds
  fold_in(key, data)       -- ``jax.random.fold_in``
  threefry2x32(k, x)       -- the Threefry-2x32 hash (20 rounds)
  random_bits(key, shape)  -- 32-bit words, the partitionable layout:
                              element i hashes the counter pair
                              (i >> 32, i & 0xFFFFFFFF), words xored
  uniform(key, shape, minval, maxval)  -- float32, the mantissa trick
  gumbel(key, shape)       -- mode "low": -log(-log(uniform(tiny, 1)))
  categorical(key, logits) -- argmax(gumbel + logits) over the last axis

Integer keys and bits are bitwise on every device.  ``uniform`` is too:
its multiply and add run as separate elementwise ops, so no FMA
contracts them.  ``gumbel`` goes through ``log``, whose last bit may
differ between implementations (the CPU's, the card's, XLA's), so its
values (and a ``categorical`` draw at a near-tie) are not bitwise
across devices.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r).bitwise_and_(M32).bitwise_or_(x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x1, x2) under key (k1, k2), as
    ``jax._src.prng._threefry2x32_lowering``: all int64 holding 32-bit
    words, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    # fresh full-shape words, updated in place from here on
    x1 = (x1 + ks[0]).expand(shape).contiguous().bitwise_and_(M32)
    x2 = (x2 + ks[1]).expand(shape).contiguous().bitwise_and_(M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(M32)
            x2 = _rotl(x2, r).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(M32)
    return x1, x2


def prng_key(seed: Union[int, torch.Tensor],
             device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: [B, 2] int64 keys
    (0, seed mod 2**32) for a seed tensor [B] (any integer dtype; its
    bit pattern is taken modulo 2**32), or [2] for an int."""
    s = torch.as_tensor(seed, device=device).long() & M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the counter pair
    (0, data mod 2**32).  key [..., 2]; data an int or a tensor that
    broadcasts against key[..., 0] (an int makes no host-to-device copy,
    so a CUDA graph can capture it)."""
    if isinstance(data, torch.Tensor):
        d = data.to(key.device).long() & M32
    else:
        d = torch.full_like(key[..., 1], int(data) & M32)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words of ``shape`` for each key, [*key.shape[:-1],
    *shape] int64 in [0, 2**32): the partitionable layout, element i
    (row-major) the xor of the two words of threefry over the counter
    pair (i >> 32, i mod 2**32) (``_threefry_random_bits_partitionable``;
    a scalar shape hashes (0, 0))."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & M32)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of each word as
    the mantissa of a float in [1, 2), minus 1, times (maxval - minval)
    plus minval (two ops, never an FMA), then at least minval.  The
    bounds enter as float32 values held in Python floats (exact), so
    nothing is copied to the device."""
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return (floats * span + lo).clamp_min(lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel``, mode "low", float32."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row:
    key [..., 2], logits [..., V] float32 -> int64 [...]; the first
    maximal index, as ``jnp.argmax``."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
