"""The port's counterparts of four public functions of the reference, each
held against the reference's on the same inputs:

* ``configs.all_configs(reduced)`` against ``repro.configs.all_configs``:
  the same 12 ids in order, every config field for field;
* ``core.quantization.dequantize_w4`` against the reference's, bit for bit,
  on the reference's ``quantize_w4`` of the same seeded weights (and on the
  port's own, which is the same codes and scales), K not a multiple of 128;
* ``models.quantized.quantized_bytes`` on the converted reduced
  llama2-7b+w4a8 tree: the reference's (dense, quantized) byte counts;
* ``kernels.gemv_w4a8.ops.linear_w4a8`` with and without a bias against
  the reference's ``linear_w4a8`` in interpret mode, within 1e-5 of the
  output's largest (the integer group sums are exact on both sides; the
  float32 sum over groups differs in order: ``tests/test_torch_gemv.py``'s
  tolerance). On the CPU the port runs the kernel's plain version; the CUDA
  kernel is held against it by ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.core import quantization as jq
from repro.kernels.gemv_w4a8 import ops as jax_gemv
from repro.models.api import build_model as jax_build_model
from repro.models.quantized import quantized_bytes as jax_quantized_bytes
from repro_torch.configs import ARCH_IDS, all_configs
from repro_torch.convert import from_jax
from repro_torch.core import quantization as tq
from repro_torch.kernels.gemv_w4a8 import ops
from repro_torch.models.quantized import quantized_bytes

LINEAR_RTOL = 1e-5


@pytest.mark.parametrize("reduced", [False, True])
def test_all_configs_equal_the_reference(reduced):
    got, want = all_configs(reduced), jax_all_configs(reduced)
    assert list(got) == list(want) == ARCH_IDS
    for name in ARCH_IDS:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name]), name


@pytest.mark.parametrize("k,n", [(300, 64), (128, 32), (4160, 48)])
def test_dequantize_w4_bitwise(k, n):
    w = np.random.default_rng(k + n).standard_normal((k, n)).astype(np.float32)
    jqw = jq.quantize_w4(jnp.asarray(w))
    want = np.asarray(jq.dequantize_w4(jqw))
    qw = tq.QuantizedLinear(torch.from_numpy(np.array(jqw.packed)),
                            torch.from_numpy(np.array(jqw.scale)), None)
    got = tq.dequantize_w4(qw)
    assert got.shape == (k, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq.dequantize_w4(tq.quantize_w4(torch.from_numpy(w))).numpy(),
                                  want)


def test_quantized_bytes_equal_the_reference():
    jm = jax_build_model(jax_get_config("llama2-7b+w4a8", reduced=True))
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    want = jax_quantized_bytes(tree)
    got = quantized_bytes(from_jax(tree, "cpu"))
    assert got == tuple(int(v) for v in want)
    assert got[0] > 3 * got[1] > 0


def _linear_inputs(m: int, k: int, n: int, bias: bool):
    rng = np.random.default_rng(m * 7 + k)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return x, jq.quantize_w4(jnp.asarray(w)), b


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 256, 96), (5, 300, 64), (12, 384, 128)])
def test_linear_w4a8_against_the_reference(m, k, n, bias):
    x, jqw, b = _linear_inputs(m, k, n, bias)
    jqw = jqw._replace(bias=None if b is None else jnp.asarray(b))
    want = np.asarray(jax_gemv.linear_w4a8(jnp.asarray(x), jqw, interpret=True))
    qw = tq.QuantizedLinear(torch.from_numpy(np.array(jqw.packed)),
                            torch.from_numpy(np.array(jqw.scale)),
                            None if b is None else torch.from_numpy(b))
    got = ops.linear_w4a8(torch.from_numpy(x), qw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= LINEAR_RTOL * scale
    plain = ops.gemv_w4a8(torch.from_numpy(x), qw.packed, qw.scale)
    if b is None:
        assert torch.equal(got, plain)
    else:
        assert torch.equal(got, plain + qw.bias)
