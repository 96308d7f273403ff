"""The port's W4A8 kernel (``kernels/gemv_w4a8``) on the CPU. The decode form
(M <= 8, quantization inside the kernel, K split over the CTAs of a
thread-block cluster): its grid plan from shapes only, the plain model of
its split of K against the reference's Pallas kernel (interpret mode), and
the int8 quantizer on rows built on its edges against the reference's
``quantize_a8``. The prefill form (M > 8, a quantize kernel then the GEMM):
its grid from shapes only, and the plain model of its code layout and
of its GEMM on those codes against the reference. The CUDA kernels run only
on a GPU; ``chip_smoke.py`` holds them against these plain versions there.

Codes and scales are compared exactly. Outputs within 1e-5: the integer
group sums are exact on both sides and only the float32 sum over groups
differs in order (the tolerance of the reference's own GEMV tests)."""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels.gemv_w4a8 import ops as jax_gemv
from repro_torch.core import quantization as tq
from repro_torch.kernels.gemv_w4a8 import ops, ref

RNG = np.random.default_rng(15)


def _groups(k: int) -> int:
    return -(-k // tq.GROUP)


@pytest.mark.parametrize("k", [64, 200, 4096, 11008])
@pytest.mark.parametrize("n", [96, 1024, 4096, 11008])
def test_decode_plan_from_shapes(k, n):
    """For every M 1-8 and a few SM counts: one grid whatever M; 1-8
    ranks, each with whole 128-row groups, covering K in order; the SMs
    filled at least once wherever some tile width can fill them, by the
    widest such tile; else the narrowest tile with every rank it can take."""
    n_groups = _groups(k)
    ks_max = min(ops.MAX_RANKS, n_groups)
    for sm_count in (132, 114, 16):
        plans = {ops.decode_plan(m, k, n, sm_count) for m in range(1, ops.DECODE_MAX_M + 1)}
        assert len(plans) == 1
        tile_bytes, ks = plans.pop()
        assert tile_bytes in ops.TILE_BYTES and 1 <= ks <= ks_max

        ranks = ref.rank_groups(n_groups, ks)
        assert ranks[0][0] == 0 and ranks[-1][1] == n_groups
        assert all(hi == lo for (_, hi), (lo, _) in zip(ranks, ranks[1:]))
        assert all(hi > lo for lo, hi in ranks)
        owner = [r for r, (lo, hi) in enumerate(ranks) for _ in range(lo, hi)]
        assert owner == sorted(owner) and len(owner) == n_groups

        ctas = {t: -(-(n // 2) // t) * ks for t in ops.TILE_BYTES}
        if ctas[ops.TILE_BYTES[-1]] >= sm_count:
            assert ctas[tile_bytes] >= sm_count
            assert all(ctas[t] < sm_count for t in ops.TILE_BYTES if t > tile_bytes)
        else:
            assert tile_bytes == ops.TILE_BYTES[-1] and ks == ks_max


SPLIT_CASES = [
    # m,  k,    n
    (1, 200, 96),        # a ragged second group
    (8, 512, 256),
    (3, 1024, 512),
    (5, 64, 96),         # one group: a single rank
    (8, 1000, 264),      # N not a multiple of 32 (the kernel's 4-byte copies)
]


def _inputs(x, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    return xj, xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SPLIT_CASES)
def test_split_model_vs_jax_kernel(m, k, n, dtype):
    """The plain model of the decode form's split (each rank's groups
    summed, the ranks merged in rank order) equals the reference kernel at
    every cluster size, and repeats itself bit for bit."""
    xj, xt = _inputs(RNG.standard_normal((m, k)).astype(np.float32), dtype)
    qw = jq.quantize_w4(jnp.asarray(RNG.standard_normal((k, n)) * 0.05, jnp.float32))
    packed, scale = (torch.from_numpy(np.array(a)) for a in (qw.packed, qw.scale))
    want = np.asarray(jax_gemv.gemv_w4a8(xj, qw.packed, qw.scale, interpret=True))
    for ks in range(1, min(ops.MAX_RANKS, _groups(k)) + 1):
        got = ref.gemv_w4a8_split_ref(xt, packed, scale, ks=ks)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        assert torch.equal(got, ref.gemv_w4a8_split_ref(xt, packed, scale, ks=ks))


def _edge_rows() -> np.ndarray:
    """Rows on the quantizer's edges: half-even ties at scale 1 (amax 127),
    an all-zero row, a row whose amax / 127 is not a bf16 value, one whose
    float reciprocal product differs from the quotient (the GPU's torch
    divides by a scalar that way), then random rows."""
    k = 300
    x = RNG.standard_normal((6, k)).astype(np.float32)
    x[0] = 0.0
    x[0, :10] = [127.0, 2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 3.5, 126.5, -126.5]
    x[1] = 0.0
    x[2] *= 3.0 / np.abs(x[2]).max()
    cands = np.linspace(1, 2, 4001, dtype=np.float32)
    recip = cands[cands * (np.float32(1) / np.float32(127)) != cands / np.float32(127)][0]
    x[3] *= recip / np.abs(x[3]).max()
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_edge_rows_match_reference(dtype):
    xj, xt = _inputs(_edge_rows(), dtype)
    qt, st = tq.quantize_a8(xt)
    qj, sj = jq.quantize_a8(xj)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the rows hit their cases: ties rounded half to even at scale 1, the
    # zero row at scale 1, a bf16 scale other than the f32 quotient
    assert st[0, 0] == 1.0 and st[1, 0] == 1.0
    assert qt[0, :10].tolist() == [127, 2, -2, 0, 0, 2, -2, 4, 126, -126]
    assert (qt[1] == 0).all()
    amax = xt[2].float().abs().max()
    assert (st[2, 0] != amax / 127) == (dtype == "bfloat16")

    n = 128
    qw = jq.quantize_w4(jnp.asarray(RNG.standard_normal((xt.shape[1], n)) * 0.05, jnp.float32))
    packed, scale = (torch.from_numpy(np.array(a)) for a in (qw.packed, qw.scale))
    want = np.asarray(jax_gemv.gemv_w4a8(xj, qw.packed, qw.scale, interpret=True))
    got = ref.gemv_w4a8_split_ref(xt, packed, scale, ks=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert (got[1] == 0).all()


PREFILL_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 1024), (200, 264),
                  (64, 96)]


@pytest.mark.parametrize("k,n", PREFILL_SHAPES)
def test_prefill_plan_from_shapes(k, n):
    """The prefill form's grid for M 9..4096: a pure function of (M, N);
    one CTA per PREFILL_TILE, tiling M x N completely (every output in
    exactly one CTA, no CTA wholly outside); llama2-7b's projections at
    M = 1024 (leg B's prefill) cover the H100's 132 SMs."""
    bn, bm = ops.PREFILL_TILE
    for m in (9, 16, 33, 64, 100, 1024, 4096):
        gx, gy = ops.prefill_plan(m, n)
        assert (gx, gy) == ops.prefill_plan(m, n)
        assert (gx - 1) * bn < n <= gx * bn and (gy - 1) * bm < m <= gy * bm
        owners = np.zeros((gy * bm, gx * bn), np.int8)
        for by in range(gy):
            for bx in range(gx):
                owners[by * bm:(by + 1) * bm, bx * bn:(bx + 1) * bn] += 1
        assert (owners == 1).all()
        if m == 1024 and (k, n) in PREFILL_SHAPES[:3]:
            assert gx * gy >= 132


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(13, 300, 128), (9, 200, 264), (33, 64, 96),
                                   (20, 1000, 256)])
def test_prefill_codes_layout_and_gemm_model(m, k, n, dtype):
    """The prefill form's code layout (``ref.pack_codes``: zero-padded to
    whole 128-row groups, each 16-code block in the MMA's k order) holds
    ``quantize_a8``'s codes, which ``ref.unpack_codes`` gives back exactly;
    the plain model of the GEMM on those codes equals the reference's
    Pallas kernel (1e-5) and the plain version (exactly)."""
    x = RNG.standard_normal((m, k)).astype(np.float32)
    if k == 300:
        x[:6] = _edge_rows()
    xj, xt = _inputs(x, dtype)
    q, s = tq.quantize_a8(xt)
    codes = ref.pack_codes(q)
    kp = _groups(k) * tq.GROUP
    assert codes.shape == (m, kp) and codes.dtype == torch.int8
    assert torch.equal(ref.unpack_codes(codes, k), q)
    blocks = codes.reshape(m, kp // 16, 16)
    padded = torch.nn.functional.pad(q, (0, kp - k)).reshape(m, kp // 16, 16)
    for i in range(16):                      # code i of a block at byte 4 (i % 4) + i // 4
        assert torch.equal(blocks[:, :, 4 * (i % 4) + i // 4], padded[:, :, i])
    if kp > k:
        assert (ref.unpack_codes(codes, kp)[:, k:] == 0).all()

    qw = jq.quantize_w4(jnp.asarray(RNG.standard_normal((k, n)) * 0.05, jnp.float32))
    packed, scale = (torch.from_numpy(np.array(a)) for a in (qw.packed, qw.scale))
    got = ref.gemv_w4a8_codes_ref(codes, s[:, 0], packed, scale)
    want = np.asarray(jax_gemv.gemv_w4a8(xj, qw.packed, qw.scale, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, ref.gemv_w4a8_ref(xt, packed, scale))


def test_launcher_argtypes_match_the_cuda_source():
    """The ctypes argument types the wrapper gives each launcher match the
    launcher's C signature in csrc/gemv_w4a8.cu (a pointer passed as a C
    int would be cut to 32 bits)."""
    import ctypes
    import re
    src = (Path(ops.__file__).resolve().parents[2] / "csrc" / "gemv_w4a8.cu").read_text()
    sigs = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(sigs) == set(ops.LAUNCHER_ARGTYPES)
    for name, params in sigs.items():
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in (q.strip() for q in params.split(","))]
        assert all(p.split()[0] in ("int", "void*", "void", "const") for p in
                   (q.strip() for q in params.split(","))), params
        assert ops.LAUNCHER_ARGTYPES[name] == want, name
