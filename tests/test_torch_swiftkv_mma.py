"""The GQA form of the port's decode attention on tensor cores
(``csrc/swiftkv_decode_mma.cu``), through its plain model
``ref.swiftkv_decode_mma_ref``, against the reference's Pallas
``swiftkv_decode`` in interpret mode and its sharded reference
(``swiftkv_decode_sharded_reference``) on the same numpy inputs; the form's
rule (``ops.kernel_form``), the split policy (``ops.split_count``) on the
card's cluster counts and its chunks, from shapes alone.

The kernel takes a bf16 q and a bf16 or int8 cache. The comparisons feed
bf16 values in float32 tensors to both sides (int8 caches with the
reference's bf16 scales), so the outputs are compared before any rounding
to bf16. Tolerance 5e-5: the model, as the kernel, feeds each weight p
(times an int8 cache's v scale) to P V in two bf16 parts, high and low,
which keep 16 of its 24 bits, so a weight is off by at most 2^-17 of
itself and the output by at most 2^-17 max|v| = 3.4e-5 at |v| < 4.5
(standard normal values at these sizes), beside f32 rounding in another
summation order. Real bf16 tensors (bf16 outputs) agree within 1e-2: both
sides round an f32-class result once, so they differ only where the two
straddle a bf16 rounding point, by one step, 2^-8 |out| < 1e-2 at
|out| < 2.5 (rows of length 1, which give |v| itself, are exact on both).
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import swiftkv as jax_swiftkv
from repro.core.quantization import quantize_kv as jax_quantize_kv
from repro.kernels.swiftkv_decode import ops as jax_ops
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.swiftkv_decode import ops
from repro_torch.kernels.swiftkv_decode import ref as kref

ATOL = 5e-5
TILE = ops.MMA_TILE
S = 4 * TILE                 # linear caches: four tiles
R = 128                      # ring slots
RING_LENS = [0, 1, R - 1, R, R + 1, 3 * R + 5]
CASES = {
    # name: (hq, hkv, d, int8, window, ring, lengths)
    "G2 D16": (4, 2, 16, False, None, False, [0, 1, TILE - 1, TILE, TILE + 1, S]),
    "G4 D80 window 50": (8, 2, 80, False, 50, False, [S, 100, 45, 1, 0]),
    "int8 G8 D80 window 50": (16, 2, 80, True, 50, False, [S, 131, 30, 1, 0]),
    "ring G4 D80 window 100": (8, 2, 80, False, 100, True, RING_LENS + [99, 101]),
    "ring int8 G2 D16 window 127": (4, 2, 16, True, 127, True, RING_LENS + [126]),
    "ring G8 D80 window 30": (16, 2, 80, False, 30, True, RING_LENS + [29, 31]),
}
_inputs: dict = {}


def bf16_values(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def case_inputs(name):
    """Numpy inputs of a case (made once, seeded): q, caches of bf16 values
    (int8 rows with the reference's bf16 scales [B, Hkv, S]), lengths, the
    dequantized f32 caches and the reference's Pallas output."""
    if name not in _inputs:
        hq, hkv, d, int8, window, ring, lens = CASES[name]
        rng = np.random.default_rng(len(_inputs) + 21)
        s_len = R if ring else S
        b = len(lens)
        q = bf16_values(rng.standard_normal((b, hq, d)))
        k = bf16_values(rng.standard_normal((b, s_len, hkv, d)))
        v = bf16_values(rng.standard_normal((b, s_len, hkv, d)))
        kw, kf, vf = {}, k, v
        if int8:
            def quant(x):
                q8, sc = jax_quantize_kv(jnp.asarray(x))
                return np.asarray(q8), np.asarray(jnp.swapaxes(sc, 1, 2).astype(jnp.bfloat16))
            (k, ks), (v, vs) = quant(k), quant(v)
            kw = {"k_scale": ks, "v_scale": vs}
            deq = lambda x8, sc: x8.astype(np.float32) * np.swapaxes(
                sc.astype(np.float32), 1, 2)[..., None]
            kf, vf = deq(k, ks), deq(v, vs)
        lengths = np.asarray(lens, np.int32)
        pallas = np.asarray(jax_ops.swiftkv_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
            window=window, ring=ring, block_k=s_len, interpret=True,
            **{n: jnp.asarray(x) for n, x in kw.items()}).astype(jnp.float32))
        _inputs[name] = (q, k, v, lengths, kw, kf, vf, pallas)
    return _inputs[name]


def to_torch(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def model(name, n_split, **over):
    q, k, v, lengths, kw, _, _, _ = case_inputs(name)
    _, _, _, _, window, ring, _ = CASES[name]
    args = {"q": to_torch(q), "k": to_torch(k), "v": to_torch(v), "lengths": to_torch(lengths),
            **{n: to_torch(x) for n, x in kw.items()}, **over}
    return kref.swiftkv_decode_mma_ref(n_split=n_split, window=window, ring=ring, **args)


def sharded(name, n_split):
    """The reference's sharded fold of every (row, query head), with the
    model's chunks as shards (a ring's on its unrolled cache: position t at
    index t). Every shard is cut to the longest chunk's length and masked by
    its own, so all rows and heads fold in one vmapped call."""
    q, _, _, lengths, _, kf, vf, _ = case_inputs(name)
    _, hkv, _, _, window, ring, _ = CASES[name]
    tl = torch.from_numpy(lengths)
    if ring:
        kf, vf = (kref.unroll_ring(torch.from_numpy(x.copy()), tl, 1).numpy() for x in (kf, vf))
        window = min(window, R)
    b, hq, d = q.shape
    n_pos = kf.shape[1]
    bounds = kref.chunk_bounds(tl, n_pos, n_split=n_split, tile=TILE, window=window)
    span = max(1, max(int((e - s0).max()) for s0, e in bounds))
    heads = np.arange(hq) // (hq // hkv)             # each query head's KV head
    k_sh, v_sh, lens = [], [], []
    for s0, s1 in bounds:
        idx = np.clip(s0.numpy()[:, None] + np.arange(span), 0, n_pos - 1)       # [B, span]
        rows = np.arange(b)[:, None]
        for x, out in ((kf, k_sh), (vf, v_sh)):
            shard = x[rows, idx][:, :, heads].transpose(0, 2, 1, 3)             # [B, Hq, span, D]
            out.append(jnp.asarray(shard.reshape(b * hq, span, d)))
        lens.append(jnp.asarray(np.repeat((s1 - s0).clamp(min=0).numpy(), hq)))
    out = jax.jit(jax.vmap(jax_swiftkv.swiftkv_decode_sharded_reference))(
        jnp.asarray(q.reshape(b * hq, d)), k_sh, v_sh, lens)
    return np.asarray(out).reshape(b, hq, d)


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_mma_model_vs_pallas_and_sharded(case, n_split):
    """The model of the GQA form, each chunk's state merged in split order,
    within ATOL of the reference's Pallas kernel and of its sharded fold of
    the same chunks; a row of length 0 is exactly 0 on both sides."""
    *_, pallas = case_inputs(case)
    got = model(case, n_split).numpy()
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, sharded(case, n_split), atol=ATOL)
    for row, length in enumerate(CASES[case][-1]):
        if length == 0:
            assert (got[row] == 0).all() and (pallas[row] == 0).all()


@pytest.mark.parametrize("case", ["G4 D80 window 50", "ring G8 D80 window 30"])
def test_mma_model_bf16_tensors_vs_pallas(case):
    """Real bf16 q and caches (bf16 outputs) against the Pallas kernel on the
    same bf16 values, within 1e-2 (module docstring)."""
    q, k, v, lengths, _, _, _, _ = case_inputs(case)
    _, _, _, _, window, ring, _ = CASES[case]
    as_bf16 = lambda x: jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_ops.swiftkv_decode(
        as_bf16(q), as_bf16(k), as_bf16(v), jnp.asarray(lengths), window=window, ring=ring,
        block_k=k.shape[1], interpret=True).astype(jnp.float32))
    bf = lambda x: to_torch(x).to(torch.bfloat16)
    got = model(case, 3, q=bf(q), k=bf(k), v=bf(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("case", ["ring G4 D80 window 100", "ring int8 G2 D16 window 127"])
def test_mma_model_ring_bitwise_its_linear_form(case, n_split):
    """The ring form folds the window's positions in the linear form's tiles
    and order: bit for bit the linear form on the unrolled cache."""
    q, k, v, lengths, kw, _, _, _ = case_inputs(case)
    window = CASES[case][4]
    tl = to_torch(lengths)
    tkw = {n: kref.unroll_ring(to_torch(x), tl, 2) for n, x in kw.items()}
    linear = kref.swiftkv_decode_mma_ref(
        to_torch(q), kref.unroll_ring(to_torch(k), tl, 1), kref.unroll_ring(to_torch(v), tl, 1),
        tl, n_split=n_split, window=window, **tkw)
    assert torch.equal(model(case, n_split), linear)


@pytest.mark.parametrize("g,d,q_dtype,kv_dtype,exp_mode,want", [
    (4, 80, torch.bfloat16, torch.bfloat16, "native", "mma"),   # h2o-danube-1.8b
    (4, 80, torch.bfloat16, torch.int8, "native", "mma"),       # its int8 ring
    (4, 128, torch.bfloat16, torch.bfloat16, "native", "mma"),  # qwen3-8b
    (2, 16, torch.bfloat16, torch.bfloat16, "native", "mma"),
    (8, 256, torch.bfloat16, torch.int8, "native", "mma"),
    (1, 128, torch.bfloat16, torch.bfloat16, "native", "fold"),  # llama2-7b: MHA
    (1, 128, torch.bfloat16, torch.int8, "native", "fold"),
    (4, 80, torch.float32, torch.bfloat16, "native", "fold"),
    (4, 80, torch.bfloat16, torch.float32, "native", "fold"),
    (4, 80, torch.float32, torch.float32, "native", "fold"),
    (4, 80, torch.bfloat16, torch.bfloat16, "lut", "fold"),
    (4, 80, torch.bfloat16, torch.int8, "lut", "fold"),
    (2, 24, torch.bfloat16, torch.bfloat16, "native", "fold"),  # D not a multiple of 16
    (3, 96, torch.bfloat16, torch.bfloat16, "native", "mma"),
])
def test_kernel_form_from_shapes_and_dtypes(g, d, q_dtype, kv_dtype, exp_mode, want):
    """The form comes from shapes, dtypes and the exponential only: G = 1,
    an f32 q or cache, the LUT and D % 16 != 0 keep the fold."""
    assert ops.kernel_form(g, d, q_dtype, kv_dtype, exp_mode) == want


# resident clusters of n = 1..8 CTAs of the GQA form on an H100
# (ops.occupancy, as tools/swiftkv_split_sweep.py prints it): bf16 caches at
# D 80 (3 CTAs an SM), D 128 (2) and D 256 (1), and an int8 cache at D 80 (5)
H100_MMA_D80 = (396, 198, 124, 92, 69, 62, 47, 45)
H100_MMA_D128 = (264, 132, 79, 62, 47, 39, 32, 30)
H100_MMA_D256 = (132, 66, 39, 30, 22, 17, 15, 15)
H100_MMA_D80_INT8 = (660, 330, 203, 154, 124, 101, 84, 77)


@pytest.mark.parametrize("b,hkv,s,window,d,int8,clusters,want", [
    (8, 8, 4224, 4096, 80, False, H100_MMA_D80, 2),   # leg D's ring (B 8, Hkv 8, R 4224)
    (8, 8, 4352, 4096, 80, False, H100_MMA_D80, 2),   # ... and its linear twin: the same split
    (4, 8, 4224, 4096, 80, False, H100_MMA_D80, 5),   # leg E's 4 slots
    (8, 8, 640, None, 128, False, H100_MMA_D128, 2),  # qwen3-8b decode at length 576: 10 tiles
    (16, 8, 4224, 4096, 80, False, H100_MMA_D80, 1),  # 128 pairs
    (2, 2, 64, None, 128, False, H100_MMA_D128, 1),   # one tile
    (1, 1, 1 << 16, None, 128, False, H100_MMA_D128, 8),  # at most MAX_SPLIT
    (1, 1, 1 << 16, 300, 128, False, H100_MMA_D128, 6),   # a window over 6 tiles
    (8, 1, 640, None, 256, False, H100_MMA_D256, 5),  # gemma-2b's MQA read (leg I)
    (8, 8, 1600, None, 128, False, H100_MMA_D128, 2),  # llama-3.2-vision's cross read (V1)
    (8, 8, 4224, 4096, 80, True, H100_MMA_D80_INT8, 5),  # leg D2's int8 ring
])
def test_mma_split_count_from_shapes_only(b, hkv, s, window, d, int8, clusters, want):
    """The split counts the tiles of min(S, window) positions, from shapes
    and the card's cluster counts alone (no lengths)."""
    row_bytes = 2 * d * (1 if int8 else 2) + (4 if int8 else 0)   # K, V (and bf16 scales)
    assert ops.split_count(b * hkv, ops.split_tiles(s, window, "mma"), TILE * row_bytes,
                           clusters, "mma") == want


@pytest.mark.parametrize("form", ["mma", "fold"])
@pytest.mark.parametrize("window", [1, 63, 64, 100, 1024, 4096])
def test_ring_and_its_linear_twin_get_one_split(form, window):
    """A ring of R slots and its linear twin (S >= R) with the same window
    below R span the same tiles, so every batch gets one split for both."""
    ring_s = window + 128
    for twin_s in (ring_s, ring_s + 1, 2 * ring_s + 77):
        assert ops.split_tiles(ring_s, window, form) == ops.split_tiles(twin_s, window, form)
        for pairs in (1, 5, 40, 64, 256):
            tiles = ops.split_tiles(ring_s, window, form)
            split = [ops.split_count(pairs, ops.split_tiles(s, window, form), 20480,
                                     H100_MMA_D80, form) for s in (ring_s, twin_s)]
            assert split[0] == split[1] and 1 <= split[0] <= min(tiles, ops.MAX_SPLIT)


@pytest.mark.parametrize("ring,window", [(False, None), (False, 1), (False, 50), (False, 100),
                                         (False, 4 * R), (True, 1), (True, 50), (True, 100),
                                         (True, 4 * R)])
def test_mma_chunks_tile_each_window(ring, window):
    """With MMA_TILE tiles, the chunks partition [lo, len) of each row in
    order, each start but the first on a tile boundary, no chunk longer than
    cdiv(tiles, n_split) tiles; a ring's in position space (unclamped
    lengths, window at most R)."""
    s_len = R if ring else S
    lengths = torch.tensor([0, 1, TILE - 1, TILE, TILE + 1, 77, s_len, s_len + 9, 3 * R + 5])
    for n_split in (1, 2, 3, 5, 8):
        bounds = kref.chunk_bounds(lengths, s_len, n_split=n_split, tile=TILE, window=window,
                                   ring=ring)
        for row, length in enumerate(lengths.tolist()):
            length = length if ring else min(length, s_len)
            span = min(window, s_len) if ring else window
            lo = max(0, length - span) if span else 0
            live = [(int(a[row]), int(e[row])) for a, e in bounds if e[row] > a[row]]
            assert [t for a, e in live for t in range(a, e)] == list(range(lo, length))
            assert all(a % TILE == 0 for a, _ in live[1:])
            n_tiles = -(-length // TILE) - lo // TILE if length > lo else 0
            assert all(-(-e // TILE) - a // TILE <= -(-n_tiles // n_split) for a, e in live)


def test_mma_launcher_argtypes_match_the_cuda_source():
    """The ctypes argument types of the GQA form's launcher and of its
    occupancy query match their C signatures (a pointer passed as an int
    would be cut to 32 bits, a float as an int misread), and its launches
    have their own count."""
    src = (Path(ops.__file__).resolve().parents[2] / "csrc" / "swiftkv_decode_mma.cu").read_text()
    sigs = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(sigs) == {"swiftkv_decode_mma_launch", "swiftkv_decode_mma_occupancy"}
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    for name, argtypes in (("swiftkv_decode_mma_launch", ops.MMA_ARGTYPES),
                           ("swiftkv_decode_mma_occupancy", ops.MMA_OCCUPANCY_ARGTYPES)):
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                for p in (x.strip() for x in sigs[name].split(","))]
        assert argtypes == want, name
    assert "swiftkv_decode_mma" in LAUNCHES
