"""Counter-based random numbers for request-intrinsic sampling: Threefry-2x32
(Salmon et al., SC'11, "Parallel random numbers: as easy as 1, 2, 3") and
the key derivation and Gumbel transform of JAX's default ``threefry2x32``
PRNG, in torch integer ops on any device.

A key is a pair of 32-bit words, held as int64 tensors ``[..., 2]`` with
values in ``[0, 2**32)`` (torch has no full unsigned 32-bit arithmetic);
every sum is masked back to 32 bits. The functions match ``jax.random``
(JAX 0.9, ``jax_threefry_partitionable`` on, its default) bit for bit:

* :func:`prng_key` is ``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed &
  0xFFFFFFFF]``;
* :func:`fold_in` is ``jax.random.fold_in``: the key hashes the counter
  pair ``(0, data)``;
* :func:`random_bits` is ``jax.random.bits`` (32-bit): element ``i`` of a
  flat shape hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and
  xors the two output words;
* :func:`gumbel` is ``jax.random.gumbel(key, shape, float32)`` (mode
  "low"): ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` from the
  top 23 bits.

Keys broadcast: a ``[B, 2]`` key with a ``[B]`` ``data`` folds in per row,
and :func:`gumbel` of a ``[B, 2]`` key draws ``[B, *shape]``, one stream
per row. No function reads a device value on the host.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds: the key words ``(k1, k2)`` hash the
    counter words ``(x1, x2)``. All int64 in ``[0, 2**32)``, broadcasting
    against each other. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**31)``: [2] int64."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"prng_key: seed must be in [0, 2**31), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: key ``[..., 2]``, ``data`` an int
    or an integer tensor broadcasting against ``key[..., 0]``. Returns the
    new key, ``[..., 2]`` of the broadcast shape."""
    if isinstance(data, int):          # a fill, not a host-to-device copy
        data = torch.full((), data & MASK, dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64: key ``[..., 2]``
    -> ``[..., *shape]``."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (y1 ^ y2).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=tiny)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, floored at tiny."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats + _TINY, _TINY)


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``: ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(key, shape)))


def seeded_gumbel_pick(base_key: torch.Tensor, logits: torch.Tensor,
                       serial, token_idx, temperature: float) -> torch.Tensor:
    """One exact softmax(logits / temperature) draw per row as Gumbel-max,
    keyed on ``(base_key, serial, token_idx)``: properties of the request,
    so a request's draw for its token i cannot depend on batch composition,
    scheduling or the decode tick horizon. Port of the reference's
    ``seeded_gumbel_pick`` (``models/transformer.py``), batched.

    logits: ``[..., V]`` f32; ``serial``/``token_idx``: ints or integer
    tensors of shape ``logits.shape[:-1]``. Returns int32 of that shape."""
    key = fold_in(fold_in(base_key, serial), token_idx)
    key = key.expand(*logits.shape[:-1], 2)
    g = gumbel(key, (logits.shape[-1],))
    scaled = logits / torch.full_like(logits, temperature)
    return (scaled + g).argmax(dim=-1).to(torch.int32)
