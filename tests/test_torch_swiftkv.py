"""The port's decode attention (``repro_torch.core.attention.decode_attention``
— the kernel path, which runs the kernel's plain version on CPU tensors, and
the blockwise and naive paths) against the reference's Pallas
``swiftkv_decode`` kernel in interpret mode, on the same numpy inputs.

Tolerance: float32 inputs agree to 2e-5 absolute — both sides compute in
f32 and differ only in summation order (the reference's own kernel tests
use the same bound); bf16 inputs to 3e-2, one bf16 step at |out| ~ 4."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import swiftkv as jax_swiftkv
from repro.core.quantization import quantize_kv as jax_quantize_kv
from repro.kernels.swiftkv_decode import ops as jax_ops
from repro_torch.core import attention as attn
from repro_torch.core import swiftkv
from repro_torch.kernels.swiftkv_decode import ops

RNG = np.random.default_rng(11)
ATOL_F32 = 2e-5

# the SWEEP of tests/test_kernels_swiftkv.py
SWEEP = [
    # b, hq, hkv, s,    d,   block
    (1, 4, 4, 256, 64, 128),    # MHA
    (2, 8, 2, 512, 64, 128),    # GQA 4:1
    (2, 8, 1, 256, 128, 128),   # MQA
    (3, 4, 2, 384, 128, 128),   # non-pow2 batch/seq
    (1, 16, 8, 1024, 64, 256),  # wide
    (1, 2, 2, 128, 256, 128),   # big head_dim (gemma-style)
]


def mk(b, hq, hkv, s, d, lengths=None):
    q = RNG.standard_normal((b, hq, d)).astype(np.float32)
    k = RNG.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = RNG.standard_normal((b, s, hkv, d)).astype(np.float32)
    if lengths is None:
        lengths = RNG.integers(1, s + 1, (b,))
    return q, k, v, np.asarray(lengths, np.int32)


def to_torch(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def port_all(q, k, v, lengths, *, block, **kw) -> dict:
    """The port's three decode paths on the same inputs, as numpy f32."""
    args = [to_torch(x) for x in (q, k, v, lengths)]
    kw = {n: (to_torch(x) if n in ("k_scale", "v_scale") else x) for n, x in kw.items()}
    return {impl: attn.decode_attention(*args, impl=impl, block_size=block,
                                        **kw).float().numpy()
            for impl in ("kernel", "blockwise", "naive")}


def jax_kernel(q, k, v, lengths, *, block, **kw) -> np.ndarray:
    kw = {n: (jnp.asarray(x) if n in ("k_scale", "v_scale") else x) for n, x in kw.items()}
    out = jax_ops.swiftkv_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lengths), block_k=block,
                                 interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", SWEEP)
def test_decode_vs_jax_kernel_f32(b, hq, hkv, s, d, blk):
    q, k, v, lengths = mk(b, hq, hkv, s, d)
    want = jax_kernel(q, k, v, lengths, block=blk)
    for impl, got in port_all(q, k, v, lengths, block=blk).items():
        np.testing.assert_allclose(got, want, atol=ATOL_F32, err_msg=impl)


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", SWEEP[:3])
def test_decode_vs_jax_kernel_bf16(b, hq, hkv, s, d, blk):
    q, k, v, lengths = mk(b, hq, hkv, s, d)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    want = jax_kernel(q, k, v, lengths, block=blk)
    for impl, got in port_all(q, k, v, lengths, block=blk).items():
        np.testing.assert_allclose(got, want, atol=3e-2, err_msg=impl)


@pytest.mark.parametrize("window", [32, 100, 4096])
def test_decode_window_vs_jax_kernel(window):
    q, k, v, lengths = mk(2, 4, 2, 512, 64)
    want = jax_kernel(q, k, v, lengths, block=128, window=window)
    for impl, got in port_all(q, k, v, lengths, block=128, window=window).items():
        np.testing.assert_allclose(got, want, atol=ATOL_F32, err_msg=impl)


def _int8_cache(x):
    """The reference's quantize_kv storage form: int8 rows + bf16 scales
    [B, Hkv, S] (position last), as numpy."""
    q8, s = jax_quantize_kv(jnp.asarray(x))
    return np.asarray(q8), np.asarray(jnp.swapaxes(s, 1, 2).astype(jnp.bfloat16))


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", SWEEP[:4])
def test_decode_int8_bf16_scales_vs_jax_kernel(b, hq, hkv, s, d, blk):
    q, k, v, lengths = mk(b, hq, hkv, s, d)
    k8, ks = _int8_cache(k)
    v8, vs = _int8_cache(v)
    want = jax_kernel(q, k8, v8, lengths, block=blk, k_scale=ks, v_scale=vs)
    for impl, got in port_all(q, k8, v8, lengths, block=blk,
                              k_scale=ks, v_scale=vs).items():
        np.testing.assert_allclose(got, want, atol=ATOL_F32, err_msg=impl)


@pytest.mark.parametrize("lens", [[0, 1, 256], [256, 256, 256], [1, 128, 255]])
def test_decode_length_edge_cases(lens):
    """Lengths at the edges; a length-0 row attends nothing and is an exact
    0 on both sides."""
    q, k, v, lengths = mk(3, 4, 2, 256, 64, lengths=lens)
    want = jax_kernel(q, k, v, lengths, block=128)
    for impl, got in port_all(q, k, v, lengths, block=128).items():
        np.testing.assert_allclose(got, want, atol=ATOL_F32, err_msg=impl)
        if lens[0] == 0:
            assert (got[0] == 0).all() and (want[0] == 0).all(), impl


def test_argument_checks_match_reference():
    """The reference's checks (ops.py:58-63) raise the same errors; the
    options not ported yet raise NotImplementedError."""
    q, k, v, lengths = (to_torch(x) for x in mk(1, 4, 2, 256, 64))
    sc = torch.ones((1, 2, 256))
    with pytest.raises(ValueError, match="both"):
        ops.swiftkv_decode(q, k, v, lengths, k_scale=sc)
    with pytest.raises(ValueError, match="window"):
        ops.swiftkv_decode(q, k, v, lengths, ring=True)
    with pytest.raises(NotImplementedError, match="ring"):
        ops.swiftkv_decode(q, k, v, lengths, ring=True, window=100)
    with pytest.raises(NotImplementedError, match="lut"):
        ops.swiftkv_decode(q, k, v, lengths, exp_mode="lut")
    with pytest.raises(NotImplementedError, match="ring"):
        attn.decode_attention(q, k, v, lengths, impl="blockwise", ring=True, window=100)
    with pytest.raises(NotImplementedError, match="tokenwise"):
        attn.decode_attention(q, k, v, lengths, impl="tokenwise")


def test_state_merge_vs_reference():
    """Folding two KV shards separately and merging the (mu, Z, Y) states
    equals the reference's merge and the one-pass result."""
    d, s = 32, 96
    q = RNG.standard_normal((d,)).astype(np.float32)
    k = RNG.standard_normal((s, d)).astype(np.float32)
    v = RNG.standard_normal((s, d)).astype(np.float32)
    valid = np.ones((s // 2,), np.float32)
    sc = ((k @ q) / np.sqrt(d)).astype(np.float32)

    def fold(mod, init, lo, hi, arr):
        return mod.state_update_block(init, arr(sc[lo:hi]), arr(v[lo:hi]), arr(valid))

    t_states = [fold(swiftkv, swiftkv.state_init(d), lo, lo + s // 2, torch.from_numpy)
                for lo in (0, s // 2)]
    j_states = [fold(jax_swiftkv, jax_swiftkv.state_init(d), lo, lo + s // 2, jnp.asarray)
                for lo in (0, s // 2)]
    got = swiftkv.state_finalize(swiftkv.state_merge(*t_states)).numpy()
    want = np.asarray(jax_swiftkv.state_finalize(jax_swiftkv.state_merge(*j_states)))
    np.testing.assert_allclose(got, want, atol=ATOL_F32)
    one_pass = swiftkv.softmax_attention_reference(
        torch.from_numpy(q)[None, None, None], torch.from_numpy(k)[None, :, None],
        torch.from_numpy(v)[None, :, None])[0, 0, 0].numpy()
    np.testing.assert_allclose(got, one_pass, atol=ATOL_F32)
