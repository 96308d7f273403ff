"""The port's decode attention (``repro_torch.core.attention.decode_attention``
— the kernel path, which runs the kernel's plain version on CPU tensors, and
the blockwise and naive paths) against the reference's Pallas
``swiftkv_decode`` kernel in interpret mode, on the same numpy inputs.

Tolerance: float32 inputs agree to 2e-5 absolute — both sides compute in
f32 and differ only in summation order (the reference's own kernel tests
use the same bound); bf16 inputs to 3e-2, one bf16 step at |out| ~ 4."""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

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
from repro_torch.kernels.swiftkv_decode import ref as kref

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                    # pragma: no cover
    from _hypothesis_compat import given, settings, st

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
    """The reference's checks (ops.py:58-63) raise the same errors.
    ``ring=True`` with a window runs (tests/test_torch_ring.py holds it to
    the reference). ``exp_mode="lut"`` runs and is held to the reference's
    Pallas LUT kernel in interpret mode (within 2e-6: every row lies in one
    block of 256, where both fold the same exponentials; the tolerance of
    rows over several blocks is tests/test_torch_numerics.py's); another
    ``exp_mode`` raises. ``impl="tokenwise"`` raises for a linear window,
    as the reference does."""
    q, k, v, lengths = mk(1, 4, 2, 256, 64)
    want = jax_kernel(q, k, v, lengths, block=256, exp_mode="lut")
    q, k, v, lengths = (to_torch(x) for x in (q, k, v, lengths))
    sc = torch.ones((1, 2, 256))
    with pytest.raises(ValueError, match="both"):
        ops.swiftkv_decode(q, k, v, lengths, k_scale=sc)
    with pytest.raises(ValueError, match="window"):
        ops.swiftkv_decode(q, k, v, lengths, ring=True)
    assert ops.swiftkv_decode(q, k, v, lengths, ring=True, window=100).shape == q.shape
    np.testing.assert_allclose(ops.swiftkv_decode(q, k, v, lengths, exp_mode="lut").numpy(),
                               want, atol=2e-6)
    with pytest.raises(ValueError, match="exp_mode"):
        ops.swiftkv_decode(q, k, v, lengths, exp_mode="exp2")
    with pytest.raises(ValueError, match="window"):
        attn.decode_attention(q, k, v, lengths, impl="blockwise", ring=True)
    with pytest.raises(NotImplementedError, match="tokenwise"):
        attn.decode_attention(q, k, v, lengths, impl="tokenwise", window=100)


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


# ---------------------------------------------------------------------------
# The kernel's split of S over CTAs (ref.swiftkv_decode_split_ref), against
# the reference's sharded model and its Pallas kernel. float32, 1e-5: both
# sides fold the same positions in f32 and differ only in summation order.
# ---------------------------------------------------------------------------

TILE = ops.TILE
SPLIT_S = 4 * TILE
SPLIT_CASES = {
    # name: (b, hq, hkv, d, lengths, window, int8)
    "ragged": (5, 4, 4, 32, [0, 1, TILE - 1, TILE, SPLIT_S], None, False),
    "window": (3, 4, 2, 32, [SPLIT_S, 100, 45], 50, False),   # lo 78, 50: inside tiles
    "int8": (3, 4, 2, 32, [0, 77, SPLIT_S], None, True),
    "gqa4": (3, 8, 2, 32, [1, TILE - 1, SPLIT_S], None, False),
}
ATOL_SPLIT = 1e-5
_split_inputs: dict = {}


def split_inputs(case):
    """Numpy inputs of a case (made once): q, k, v, lengths and, for int8,
    the reference's int8 rows with bf16 scales plus their dequantized f32."""
    if case not in _split_inputs:
        b, hq, hkv, d, lens, window, int8 = SPLIT_CASES[case]
        q, k, v, lengths = mk(b, hq, hkv, SPLIT_S, d, lengths=lens)
        kw = {}
        if int8:
            k8, ks = _int8_cache(k)
            v8, vs = _int8_cache(v)
            deq = lambda x8, sc: x8.astype(np.float32) * np.swapaxes(
                sc.astype(np.float32), 1, 2)[..., None]
            k, v, kw = k8, v8, {"k_scale": ks, "v_scale": vs}
            kf, vf = deq(k8, ks), deq(v8, vs)
        else:
            kf, vf = k, v
        want_pallas = jax_kernel(q, k, v, lengths, block=SPLIT_S, window=window, **kw)
        _split_inputs[case] = (q, k, v, lengths, window, kw, kf, vf, want_pallas)
    return _split_inputs[case]


def jax_sharded(q, kf, vf, bounds):
    """The reference's ``swiftkv_decode_sharded_reference`` on each (row,
    query head), with the port's chunks as shards; an empty chunk is a
    one-row shard of length 0."""
    b, hq, d = q.shape
    hkv = kf.shape[2]
    out = np.zeros((b, hq, d), np.float32)
    for row in range(b):
        spans = [(int(s0[row]), int(s1[row])) for s0, s1 in bounds]
        for h in range(hq):
            kv_h = h // (hq // hkv)
            k_sh, v_sh, lens = [], [], []
            for s0, s1 in spans:
                lo = min(s0, SPLIT_S - 1)
                hi = max(s1, lo + 1)
                k_sh.append(jnp.asarray(kf[row, lo:hi, kv_h]))
                v_sh.append(jnp.asarray(vf[row, lo:hi, kv_h]))
                lens.append(max(0, s1 - s0))
            out[row, h] = np.asarray(jax_swiftkv.swiftkv_decode_sharded_reference(
                jnp.asarray(q[row, h]), k_sh, v_sh, lens))
    return out


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_ref_vs_jax_sharded_and_pallas(case, n_split):
    """Each chunk's partial state, merged in split order, equals the
    reference's sharded fold of the same chunks and its Pallas kernel;
    chunks past a row's prefix are empty, and a length-0 row is exactly 0."""
    q, k, v, lengths, window, kw, kf, vf, want_pallas = split_inputs(case)
    tq, tl = to_torch(q), to_torch(lengths)
    bounds = kref.chunk_bounds(tl, SPLIT_S, n_split=n_split, window=window)
    got = kref.swiftkv_decode_split_ref(
        tq, to_torch(k), to_torch(v), tl, n_split=n_split, window=window,
        **{n: to_torch(x) for n, x in kw.items()}).numpy()
    np.testing.assert_allclose(got, jax_sharded(q, kf, vf, bounds), atol=ATOL_SPLIT)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL_SPLIT)
    for row, length in enumerate(lengths):
        if length == 0:
            assert (got[row] == 0).all() and (want_pallas[row] == 0).all()


@pytest.mark.parametrize("n_split", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("window", [None, 1, 50, 4 * SPLIT_S])
def test_chunk_bounds_tile_the_prefix(n_split, window):
    """The chunks partition [lo, len) in order, each start but the first on
    a tile boundary, no chunk longer than cdiv(tiles, n_split) tiles."""
    lengths = torch.tensor([0, 1, TILE - 1, TILE, TILE + 1, 77, SPLIT_S, SPLIT_S + 9])
    bounds = kref.chunk_bounds(lengths, SPLIT_S, n_split=n_split, window=window)
    for row, length in enumerate(lengths.clamp(max=SPLIT_S).tolist()):
        lo = max(0, length - window) if window else 0
        spans = [(int(s0[row]), int(s1[row])) for s0, s1 in bounds]
        live = [(a, e) for a, e in spans if e > a]
        covered = [t for a, e in live for t in range(a, e)]
        assert covered == list(range(lo, length)), (row, spans)
        n_tiles = -(-length // TILE) - lo // TILE if length > lo else 0
        for a, e in live[1:]:
            assert a % TILE == 0
        for a, e in live:
            assert -(-e // TILE) - a // TILE <= -(-n_tiles // n_split)


# resident clusters of n = 1..8 CTAs of the fold on an H100 (ops.occupancy,
# as tools/swiftkv_split_sweep.py prints it): bf16 cache at D 128 (4 CTAs an
# SM) and at D 64 (6)
H100_FOLD_D128 = (528, 264, 163, 124, 94, 79, 69, 62)
H100_FOLD_D64 = (792, 396, 248, 186, 146, 124, 101, 92)


@pytest.mark.parametrize("b,hkv,s,d,clusters,want", [
    (8, 32, 640, 128, H100_FOLD_D128, 1),   # llama2-7b decode: 256 pairs fill the card
    (8, 8, 640, 128, H100_FOLD_D128, 3),    # 64 pairs
    (5, 4, 256, 128, H100_FOLD_D128, 4),    # 20 pairs
    (1, 1, 64, 128, H100_FOLD_D128, 2),     # no more splits than the cache has tiles
    (1, 1, 1 << 16, 128, H100_FOLD_D128, 8),  # at most MAX_SPLIT, the portable cluster size
    (8, 12, 1500, 64, H100_FOLD_D64, 3),    # whisper-small's cross read (leg W1)
])
def test_split_count_from_shapes_only(b, hkv, s, d, clusters, want):
    """The split comes from shapes and the card's cluster counts alone (no
    lengths)."""
    tile_bytes = ops.TILE * 2 * d * 2                 # K and V rows of a bf16 tile
    assert ops.split_count(b * hkv, ops.split_tiles(s, None, "fold"), tile_bytes, clusters,
                           "fold") == want


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=1, max_value=4096), st.integers(min_value=1, max_value=5000),
       st.integers(min_value=1, max_value=1 << 17),
       st.lists(st.integers(min_value=0, max_value=2000), min_size=8, max_size=8))
def test_split_count_in_range_on_any_card(pairs, tiles, tile_bytes, table):
    """For any P, T and tile and any table of resident clusters that does
    not grow with n (the first at least 1), the split is in
    1..min(T, MAX_SPLIT) and the card holds its cluster."""
    clusters = sorted(table, reverse=True)
    clusters[0] = max(clusters[0], 1)
    for form in ("fold", "mma"):
        n = ops.split_count(pairs, tiles, tile_bytes, clusters, form)
        assert 1 <= n <= min(tiles, ops.MAX_SPLIT) and clusters[n - 1] >= 1


def test_split_plan_asks_the_instance_once_per_call(monkeypatch):
    """split_plan asks :func:`ops.occupancy` for the launch's own instance
    (form, G, D, dtypes, scale dtype, LUT) and counts a tile's K and V rows
    and an int8 cache's scales; it reads no lengths."""
    asked = []

    def occupancy(*args):
        asked.append(args)
        return 4, H100_FOLD_D128
    monkeypatch.setattr(ops, "occupancy", occupancy)
    ops._split_plan.cache_clear()
    try:
        q = torch.zeros(8, 32, 128, dtype=torch.bfloat16)
        k = torch.zeros(8, 640, 32, 128, dtype=torch.bfloat16)
        assert ops.split_plan(q, k) == 1
        assert asked == [("fold", 1, 128, torch.bfloat16, torch.bfloat16, None, False, None)]
        assert ops.split_plan(q, k) == 1 and len(asked) == 1      # kept per shape
        k8 = torch.zeros(8, 640, 32, 128, dtype=torch.int8)
        ks = torch.zeros(8, 32, 640, dtype=torch.bfloat16)
        want = ops.split_count(256, 20, ops.TILE * (2 * 128 + 2 * 2), H100_FOLD_D128, "fold")
        assert ops.split_plan(q, k8, k_scale=ks, exp_mode="lut") == want
        assert asked[-1] == ("fold", 1, 128, torch.bfloat16, torch.int8, torch.bfloat16, True,
                             None)
    finally:
        ops._split_plan.cache_clear()


def test_split_constants_are_the_fit_of_the_kept_sweeps():
    """``ops.SATURATION_BYTES`` and ``ops.MERGE_TILES`` are what
    ``tools/swiftkv_split_fit.py`` fits to the n_split sweeps kept in
    ``tools/swiftkv_split_sweeps/`` (two runs on an H100), and with them
    the policy's pick is within 1.07x of each sweep's best at every fitted
    shape."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "tools" / "swiftkv_split_fit.py"
    spec = importlib.util.spec_from_file_location("swiftkv_split_fit", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cases = tool.load(tool.kept_sweeps())
    assert {c["form"] for c in cases} == {"fold", "mma"}
    assert tool.fit(cases) == (ops.SATURATION_BYTES, ops.MERGE_TILES)
    fitted = [c for c in cases if not c.get("held_out")]
    assert max(tool.regret(c) for c in fitted) <= 1.07


def test_occupancy_argtypes_match_the_cuda_source():
    """The ctypes argument types of the fold's occupancy query match its C
    signature (a pointer passed as an int would be cut to 32 bits)."""
    src = (Path(ops.__file__).resolve().parents[2] / "csrc" / "swiftkv_decode.cu").read_text()
    (params,) = re.findall(r'extern "C" int swiftkv_decode_occupancy\(([^)]*)\)', src)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in (x.strip() for x in params.split(","))]
    assert ops.OCCUPANCY_ARGTYPES == want
