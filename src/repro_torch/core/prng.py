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
* :func:`split` is ``jax.random.split(key, num)``: key ``i`` hashes the
  counter pair ``(0, i)``, so it equals ``fold_in(key, i)``;
* :func:`uniform` is ``jax.random.uniform(key, shape, dtype, minval,
  maxval)`` for float32 and bfloat16: the top mantissa bits of a float in
  ``[1, 2)``, minus 1, scaled; a bfloat16 draw takes 8 random bits (the
  low byte of each 32-bit word), as JAX does for a dtype of fewer than 8
  mantissa bits, so it is not a float32 draw rounded;
* :func:`gumbel` is ``jax.random.gumbel(key, shape, float32)`` (mode
  "low"): ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` from the
  top 23 bits;
* :func:`categorical` is ``jax.random.categorical(key, logits,
  shape=shape)`` (with replacement): ``argmax(logits + gumbel)``;
* :func:`normal` is ``jax.random.normal(key, shape, dtype)``: ``sqrt(2)
  erfinv(u)`` with ``u`` uniform on ``(-1, 1)`` in ``dtype`` and XLA's
  float32 polynomial for ``erfinv`` (:func:`erf_inv`).

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


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: key ``[2]`` -> ``[num, 2]``; key
    ``i`` is ``fold_in(key, i)``."""
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def _bits_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The 32-bit words at flat indices ``idx`` of a ``random_bits`` draw:
    key ``[..., 2]``, ``idx`` int64 ``[n]`` -> ``[..., n]``."""
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return y1 ^ y2


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64: key ``[..., 2]``
    -> ``[..., *shape]``."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return _bits_at(key, idx).reshape(*key.shape[:-1], *shape)


def _unit(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Random words -> floats in ``[0, 1)`` of ``dtype``, as JAX's
    ``_uniform`` makes them: the top mantissa bits of a float in [1, 2)
    (float32: 23 of 32 bits; bfloat16: 7 of the low 8), minus 1."""
    if dtype == torch.float32:
        mant = (bits >> 9) | 0x3F800000
        return mant.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.bfloat16:
        mant = ((bits & 0xFF) >> 1) | 0x3F80
        return mant.to(torch.int16).view(torch.bfloat16) - 1.0
    raise NotImplementedError(f"uniform: dtype {dtype} (float32 | bfloat16)")


def uniform(key: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: ``max(minval,
    u * (maxval - minval) + minval)`` in ``dtype``, ``u`` from
    :func:`_unit`. In float32 the multiply-add is fused, one rounding, as
    XLA contracts it (an FMA through float64: the product is exact there)."""
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    floats = _unit(random_bits(key, shape), dtype)
    if dtype == torch.float32:
        out = (floats.double() * (hi - lo).double() + lo.double()).float()
    else:
        out = floats * (hi - lo) + lo
    return torch.maximum(lo, out)


def _gumbel_unit(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float32 on ``[tiny, 1)``, the Gumbel draw's ``uniform(key,
    shape, float32, tiny, 1)``: the scale ``1 - tiny`` rounds to 1."""
    return torch.clamp_min(_unit(bits, torch.float32) + _TINY, _TINY)


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``: ``-log(-log(u))``."""
    return -torch.log(-torch.log(_gumbel_unit(random_bits(key, shape))))


_PIECE = 1 << 25     # Gumbel draws a categorical makes at once


def categorical(key: torch.Tensor, logits: torch.Tensor, shape: tuple[int, ...]
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` for a 1-d
    float32 ``logits`` [V]: ``argmax(logits + gumbel(key, (*shape, V)))``
    over V, as int32. The Gumbel draw is made in pieces of whole rows of
    at most ``_PIECE`` draws (a piece hashes its own flat indices), so a
    large draw (1.05 GB of float32 for a batch of 8 x 1025 tokens at vocab
    32000, and its int64 Threefry temporaries) never exists whole; the
    values do not depend on the piece size."""
    v = logits.shape[-1]
    rows = 1
    for s in shape:
        rows *= s
    step = max(1, _PIECE // v)
    out = []
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        idx = torch.arange(lo * v, hi * v, dtype=torch.int64, device=key.device)
        g = -torch.log(-torch.log(_gumbel_unit(_bits_at(key, idx)))).view(hi - lo, v)
        out.append((g + logits).argmax(dim=-1))
    return torch.cat(out).view(shape).to(torch.int32)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function", GPU
# Computing Gems Jade, 2011), as ``chlo.erf_inv`` expands it: a degree-8
# polynomial in w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` on XLA: the polynomial in float32 (a bfloat16 input
    is taken up to float32 and the result rounded back), ``+-inf`` at
    ``+-1``."""
    dt = x.dtype
    xf = x.float()
    w = -torch.log1p(xf * -xf)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coeff = lambda i: torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])
    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coeff(i) + p * w
    out = torch.where(xf.abs() == 1.0, xf * float("inf"), p * xf)
    return out.to(dt)


def normal(key: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for float32 and bfloat16:
    ``sqrt(2) * erfinv(u)``, ``u`` uniform on ``(nextafter(-1, 0), 1)`` in
    ``dtype`` (a bfloat16 draw from 8-bit uniforms), every op in
    ``dtype``."""
    lo = -1 + 2.0 ** (-24 if dtype == torch.float32 else -8)     # nextafter(-1, 0)
    u = uniform(key, shape, dtype, lo, 1.0)
    return torch.tensor(2 ** 0.5, dtype=dtype, device=key.device) * erf_inv(u)


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
