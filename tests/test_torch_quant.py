"""The port's W4A8 quantization (``repro_torch.core.quantization``) and the
GEMV kernel's plain version against the reference on the same numpy inputs.

Integer codes and scales are compared exactly: both sides round half to
even and compute the scales with the same float32 operations. The clip
search of ``quantize_w4`` keeps a candidate only on a strictly smaller
error; an error sum taken in another order can tie-break differently, so
a differing (group, channel) is accepted only as such a tie, and reported.
The GEMV's integer group sums are exact on both sides; only the float32 sum
over groups differs in order (tolerance 1e-5, as the reference's own GEMV
tests use)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels.gemv_w4a8 import ops as jax_gemv
from repro_torch.core import quantization as tq
from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops

RNG = np.random.default_rng(5)


def test_unpack_w4_exact():
    packed = RNG.integers(0, 256, (96, 40), dtype=np.uint8)
    got = tq.unpack_w4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.unpack_w4(jnp.asarray(packed))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_a8_exact(dtype):
    x = (RNG.standard_normal((6, 200)) * RNG.uniform(0.01, 10, (6, 1))).astype(np.float32)
    x[2] = 0.0                                       # all-zero token: scale 1
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qt, st = tq.quantize_a8(xt)
    qj, sj = jq.quantize_a8(xj)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_kv_exact():
    x = RNG.standard_normal((3, 17, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # all-zero row: scale 0
    x[1, 3, 1] = -0.75                               # constant row: exact round trip
    qt, st = tq.quantize_kv(torch.from_numpy(x))
    qj, sj = jq.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tq.dequantize_kv(qt, st).numpy(),
                                  np.asarray(jq.dequantize_kv(qj, sj)))


@pytest.mark.parametrize("k,n", [(64, 96), (300, 264), (512, 256), (1024, 512)])
def test_quantize_w4_exact_or_tie(k, n):
    w = (RNG.standard_normal((k, n)) * 0.05).astype(np.float32)
    got = tq.quantize_w4(torch.from_numpy(w))
    want = jq.quantize_w4(jnp.asarray(w))
    s_got, s_want = got.scale.numpy(), np.asarray(want.scale)
    differ = s_got != s_want                                     # [G, N]
    if differ.any():
        # each differing scale must be a tie of the clip search: both
        # candidates' squared errors equal to float32 rounding
        wg = np.pad(w, ((0, (-k) % tq.GROUP), (0, 0))).reshape(-1, tq.GROUP, n)

        def sq_err(s):
            q = np.clip(np.round(wg / s[:, None, :]), -8, 7)
            return ((q * s[:, None, :] - wg) ** 2).sum(axis=1)
        e_got, e_want = sq_err(s_got), sq_err(s_want)
        gap = np.abs(e_got - e_want)[differ] / e_want[differ]
        print(f"quantize_w4 K={k} N={n}: {differ.sum()} tie(s), max relative "
              f"error gap {gap.max():.3g}")
        assert gap.max() < 1e-5
    # packed bytes agree wherever both channels of the byte kept one scale
    rows_ok = ~np.repeat(differ, tq.GROUP, axis=0)[:k]           # [K, N]
    byte_ok = rows_ok[:, 0::2] & rows_ok[:, 1::2]
    np.testing.assert_array_equal(got.packed.numpy()[byte_ok],
                                  np.asarray(want.packed)[byte_ok])


# the SWEEP of tests/test_kernels_gemv.py, plus the reduced models' K = 64
# (the padded-group path) and a K that is not a group multiple
GEMV_SWEEP = [
    # m,  k,    n
    (1, 512, 512),
    (8, 1024, 512),
    (3, 768, 1024),
    (16, 512, 256),
    (32, 2048, 1024),
    (5, 64, 96),
    (13, 300, 258),
]


@pytest.mark.parametrize("m,k,n", GEMV_SWEEP)
def test_gemv_plain_vs_jax_kernel(m, k, n):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    qw = jq.quantize_w4(jnp.asarray(RNG.standard_normal((k, n)) * 0.05, jnp.float32))
    want = np.asarray(jax_gemv.gemv_w4a8(jnp.asarray(x), qw.packed, qw.scale,
                                         interpret=True))
    got = gemv_ops.gemv_w4a8(torch.from_numpy(x), torch.from_numpy(np.array(qw.packed)),
                             torch.from_numpy(np.array(qw.scale)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_gemv_lead_dims_and_reference_matmul():
    """[..., K] inputs keep their leading dims; the kernel's plain version is
    the reference's w4a8_matmul_ref semantics."""
    x = RNG.standard_normal((2, 3, 512)).astype(np.float32)
    qw = jq.quantize_w4(jnp.asarray(RNG.standard_normal((512, 256)) * 0.05, jnp.float32))
    packed, scale = (torch.from_numpy(np.array(a)) for a in (qw.packed, qw.scale))
    got = gemv_ops.gemv_w4a8(torch.from_numpy(x), packed, scale)
    assert got.shape == (2, 3, 256)
    want = np.asarray(jq.w4a8_matmul_ref(jnp.asarray(x), qw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
