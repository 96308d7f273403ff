"""FXP32 Q15.17 fixed-point emulation (paper §III). Numpy copy of
``repro.core.fixedpoint``.

The paper's FPGA computes all of SwiftKV attention in 32-bit fixed point,
Q15.17 (15 integer bits, 17 fractional, 1 sign), claiming end-to-end
attention precision better than 1e-5. GPUs have no fixed-point datapath
either, so this is a *bit-accurate numpy emulation* used to validate that
claim; the serving path runs bf16/f32.

numpy int64 holds every intermediate exactly: Q15.17 x Q15.17 products are
<= 62 bits before the renormalizing shift.
"""
from __future__ import annotations

import numpy as np

from .exp2_lut import exp_lut_fxp, FRAC_BITS

ONE = 1 << FRAC_BITS
_INT32_MIN = -(1 << 31)
_INT32_MAX = (1 << 31) - 1


def to_fxp(x: np.ndarray) -> np.ndarray:
    """float -> Q15.17 (round-to-nearest, saturating like the hardware)."""
    q = np.round(np.asarray(x, np.float64) * ONE)
    return np.clip(q, _INT32_MIN, _INT32_MAX).astype(np.int64)


def from_fxp(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float64) / ONE


def fxp_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Q15.17 multiply: 64-bit product, round-to-nearest shift right 17,
    saturate to 32 bits."""
    p = np.asarray(a, np.int64) * np.asarray(b, np.int64)
    p = (p + (1 << (FRAC_BITS - 1))) >> FRAC_BITS
    return np.clip(p, _INT32_MIN, _INT32_MAX)


def fxp_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Q15.17 divide: (a << 17) / b with truncation."""
    num = np.asarray(a, np.int64) << FRAC_BITS
    b = np.asarray(b, np.int64)
    b_safe = np.where(b == 0, 1, b)
    # round-to-nearest division (hardware divider with rounding stage)
    half = np.abs(b_safe) >> 1
    q = (num + np.where((num < 0) != (b_safe < 0), -half, half)) // b_safe
    return np.clip(np.where(b == 0, 0, q), _INT32_MIN, _INT32_MAX)


def fxp_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Dot product along the last axis with a 64-bit accumulator (the MAC
    array accumulates full products before the final renormalization)."""
    acc = np.sum(np.asarray(a, np.int64) * np.asarray(b, np.int64), axis=-1)
    acc = (acc + (1 << (FRAC_BITS - 1))) >> FRAC_BITS
    return np.clip(acc, _INT32_MIN, _INT32_MAX)


def swiftkv_attention_fxp(q: np.ndarray, k: np.ndarray, v: np.ndarray,
                          scale: float | None = None) -> np.ndarray:
    """The full SwiftKV recurrence (Eqs. 5-8) in Q15.17 with the Eq. 9-10 LUT
    exponential — the paper's datapath end to end.

    q: [D] float; k, v: [S, D] float. Returns float64 attention output.
    """
    d = q.shape[-1]
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    scale_fxp = to_fxp(scale)
    qf = to_fxp(q)
    kf = to_fxp(k)
    vf = to_fxp(v)
    s_all = fxp_mul(fxp_dot(qf[None, :], kf), scale_fxp)   # Eq. 5, [S]

    mu = s_all[0]
    z = ONE                       # Z_1 = 1.0
    y = vf[0].astype(np.int64)    # Y_1 = v_1
    for t in range(1, k.shape[0]):
        s_t = s_all[t]
        if s_t <= mu:                                      # Eq. 6
            beta = exp_lut_fxp(s_t - mu)
            z = z + beta
            y = y + fxp_mul(beta, vf[t])
        else:                                              # Eq. 7
            alpha = exp_lut_fxp(mu - s_t)
            z = fxp_mul(alpha, z) + ONE
            y = fxp_mul(alpha, y) + vf[t]
            mu = s_t
        z = int(np.clip(z, _INT32_MIN, _INT32_MAX))
        y = np.clip(y, _INT32_MIN, _INT32_MAX)
    out = fxp_div(y, z)                                    # Eq. 8
    return from_fxp(out)
