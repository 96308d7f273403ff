"""LUT-based exponential (paper Eqs. 9-10). Mirror of ``repro.core.exp2_lut``.

``exp(x) = 2^{x log2 e} = 2^{n + f}`` with integer ``n <= 0`` (bit shift) and
fractional ``f in (-1, 0]`` approximated by a 32-entry lookup table with
linear interpolation:

    u = -f in [0, 1);   i = top 5 fractional bits of u;  f2 = remaining bits
    2^f ~= LUT[i] + delta_i * f2,   LUT[i] = 2^{-i/32}

Two realizations, as in the reference:
  * float path (:func:`exp2_frac_lut` / :func:`exp_lut`), float32 torch;
  * Q15.17 integer path (:func:`exp_lut_fxp`), numpy int64, bit-accurate to
    the hardware datapath of paper §III.

The float path gives the bits of the reference compiled by XLA (under
``jax.jit``, or inside a kernel) on a CPU or a TPU, which differs from plain
IEEE float32 in two places, both copied on purpose:
  * ``base + slope * f2`` is one fused multiply-add (XLA contracts it);
    :func:`fma_f32` computes it with a single rounding;
  * results below 2^-126 (subnormal) are 0: XLA flushes subnormals there.
    Eager (op-by-op) calls of the reference round the product first and
    differ from both this and the jitted reference in the last bit at
    ~0.2% of points.

No tensor is built at import: the tables stay numpy until
:func:`lut_tensors` makes them on a device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

LOG2_E = 1.4426950408889634
LUT_BITS = 5
LUT_SIZE = 1 << LUT_BITS          # 32
FRAC_BITS = 17                    # Q15.17
F2_BITS = FRAC_BITS - LUT_BITS    # 12
FLT_MIN = 2.0 ** -126             # smallest normal float32


def make_lut() -> tuple[np.ndarray, np.ndarray]:
    """Returns (values, slopes): LUT[i] = 2^{-i/32}; slope_i interpolates to
    LUT[i+1] (with LUT[32] = 0.5) over the f2 in [0,1) sub-interval."""
    i = np.arange(LUT_SIZE + 1)
    vals = 2.0 ** (-i / LUT_SIZE)
    slopes = vals[1:] - vals[:-1]          # negative; per unit of f2 in [0,1)
    return vals[:-1], slopes


_LUT_VALS, _LUT_SLOPES = make_lut()


@functools.cache
def lut_tensors(device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(values, slopes) as float32 [32] tensors on ``device`` (the
    reference casts the float64 table to float32)."""
    return (torch.tensor(_LUT_VALS, dtype=torch.float32, device=device),
            torch.tensor(_LUT_SLOPES, dtype=torch.float32, device=device))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add is. The product is exact in float64; the sum is rounded
    to odd there (round to nearest, then one float64 step toward the exact
    value where that left an even significand and an error), and a
    round-to-odd result of 53 bits rounds to 24 bits as the exact value
    would. Needs ``|c| >= |a * b|`` (the sum's error is then exact)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    err = p - (s - cd)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def exp2_frac_lut(f: torch.Tensor) -> torch.Tensor:
    """2^f for float32 f in (-1, 0] via Eq. 10 (float realization): the
    interpolation as one fused multiply-add."""
    vals, slopes = lut_tensors(f.device)
    u = -f * LUT_SIZE                               # [0, 32)
    idx = u.to(torch.int32).clamp(0, LUT_SIZE - 1)
    f2 = u - idx.to(f.dtype)
    idx = idx.long()
    return fma_f32(slopes[idx], f2, vals[idx])


def exp_lut(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for float32 x <= 0 via Eq. 9: 2^{n+f}, n = ceil(y) <= 0, f in
    (-1, 0], scaled by 2^n as the reference's ``ldexp`` does: exact where
    the result is a normal float32, 0 below."""
    y = x * LOG2_E
    n = torch.ceil(y)
    frac = exp2_frac_lut(y - n)
    # 2^n as a float64 built from exponent bits; n < -127 gives 0 anyway
    pow2n = ((n.clamp(-127, 0).to(torch.int64) + 1023) << 52).view(torch.float64)
    out = frac.double() * pow2n
    return torch.where(out < FLT_MIN, 0.0, out).float()


# ---------------------------------------------------------------------------
# Bit-accurate Q15.17 integer datapath (numpy; validation oracle)
# ---------------------------------------------------------------------------

# table entries and slopes stored in Q15.17; slopes are per-unit-of-f2 where
# f2 is the 12-bit remainder (value f2 / 2^12 of one LUT step = /2^17 of 1.0)
_LUT_VALS_FXP = np.round(_LUT_VALS * (1 << FRAC_BITS)).astype(np.int64)
_NEXT = np.round(np.append(_LUT_VALS, 0.5) * (1 << FRAC_BITS)).astype(np.int64)
_LUT_SLOPES_FXP = _NEXT[1:] - _NEXT[:-1]   # delta over one step, Q15.17


def exp_lut_fxp(x_fxp: np.ndarray) -> np.ndarray:
    """exp(x) on Q15.17 integers, x <= 0, returned in Q15.17. Mirrors the
    §III hardware datapath: multiply by log2(e) (Q15.17 constant), split
    n/f, 5-bit LUT index, 12-bit linear interpolation (Eq. 10), then an
    n-bit right shift for 2^n."""
    x_fxp = np.asarray(x_fxp, np.int64)
    log2e = np.int64(round(LOG2_E * (1 << FRAC_BITS)))
    y = (x_fxp * log2e) >> FRAC_BITS                      # Q15.17, y <= 0
    # n = ceil(y / 2^17): floor-division plus one when a remainder exists
    n = np.where(y % (1 << FRAC_BITS) == 0, y >> FRAC_BITS, (y >> FRAC_BITS) + 1)
    f = y - (n << FRAC_BITS)                              # in (-2^17, 0]
    u = -f                                                # [0, 2^17)
    idx = (u >> F2_BITS).astype(np.int64)                 # 5-bit index
    f2 = u & ((1 << F2_BITS) - 1)                         # 12-bit remainder
    base = _LUT_VALS_FXP[idx]
    slope = _LUT_SLOPES_FXP[idx]
    frac = base + ((slope * f2 + (1 << (F2_BITS - 1))) >> F2_BITS)  # Q15.17, rounded
    shift = np.minimum((-n).astype(np.int64), 62)         # n <= 0
    return frac >> shift                                  # 2^{n}·2^{f}, Q15.17


def max_relative_error(num_points: int = 200_000) -> float:
    """Max relative error of the float LUT path over (-1, 0] (paper:
    5.86e-5), evaluated in float32."""
    f = -np.linspace(1e-9, 1.0 - 1e-9, num_points, dtype=np.float64)
    approx = exp2_frac_lut(torch.from_numpy(f.astype(np.float32))).double().numpy()
    exact = 2.0 ** f
    return float(np.max(np.abs(approx - exact) / exact))
