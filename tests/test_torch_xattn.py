"""The port's pooled cross-attention read against the reference on the CPU:
``core/swiftkv.swiftkv_decode_pooled`` and
``core/attention.decode_cross_attention`` (its ``naive``, ``blockwise``
and ``kernel`` routes; ``kernel`` takes the decode kernel's ``entries=``
form, whose wrapper runs the blockwise pooled loop on CPU tensors) against
the reference's ``decode_cross_attention``, on the same numpy inputs, with
rows that share an entry, rows of ``src_len == 0`` and pools of more
entries than rows (E > B). The kernels' plain models with ``entries=``
(``ref.swiftkv_decode_split_ref``, ``ref.swiftkv_decode_mma_ref``) are bit
for bit the same models on the gathered per-row copy; the launchers'
ctypes signatures match the C sources; ``SourceKVPool`` gives the
reference's entries and refcounts on the same call sequence.

Tolerance: float32 at 1e-6 absolute (both sides fold the same 512-row
blocks in f32; only reduction order inside a block differs); bf16 pools
at 2e-2 and int8 pools with bf16 scales at 2e-5 (f32 q: the pools'
values are exact in f32 on both sides, so only summation order moves the
output, at |out| ~ 1)."""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jax_attn
from repro.core.quantization import quantize_kv as jax_quantize_kv
from repro.serving.slot_pool import SourceKVPool as JaxSourceKVPool
from repro_torch.core import attention as attn
from repro_torch.core import swiftkv
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.swiftkv_decode import ops
from repro_torch.kernels.swiftkv_decode import ref as kref
from repro_torch.serving import SourceKVPool

RNG = np.random.default_rng(23)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


# B rows, E entries (E > B), Hq, Hkv, S_src, D; rows 1 and 3 share entry
# 5, row 2 reads an entry of src_len 0, entries reach past B
CASES = [
    # b, e, hq, hkv, s, d, block
    (4, 7, 4, 4, 40, 16, 512),        # whisper's shape, reduced (G 1)
    (4, 7, 8, 2, 40, 16, 16),         # vision's GQA, several blocks
    (5, 9, 16, 2, 1100, 32, 512),     # three 512-row blocks, ragged tail
]


def _inputs(b, e, hq, hkv, s, d):
    q = RNG.standard_normal((b, hq, d)).astype(np.float32)
    k = RNG.standard_normal((e, s, hkv, d)).astype(np.float32)
    v = RNG.standard_normal((e, s, hkv, d)).astype(np.float32)
    entries = np.array(([6, 5, 2, 5] + list(range(b)))[:b], np.int32)
    src_len = RNG.integers(1, s + 1, (e,)).astype(np.int32)
    src_len[2] = 0                                  # an entry with no source
    src_len[6] = s                                  # and a full one
    return q, k, v, entries, src_len[entries]


def _jax(q, k, v, entries, lengths, impl, block, **kw):
    kw = {n: jnp.asarray(x) for n, x in kw.items()}
    out = jax_attn.decode_cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(entries), jnp.asarray(lengths),
                                          impl=impl, block_size=block, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, entries, lengths, impl, block, **kw):
    kw = {n: _t(x) for n, x in kw.items()}
    out = attn.decode_cross_attention(_t(q), _t(k), _t(v), _t(entries), _t(lengths),
                                      impl=impl, block_size=block, **kw)
    return out.float().numpy()


@pytest.mark.parametrize("impl", ["kernel", "blockwise", "naive", "tokenwise"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}e{}h{}/{}s{}d{}".format(*c[:6]))
def test_decode_cross_attention_f32_vs_reference(case, impl):
    b, e, hq, hkv, s, d, block = case
    q, k, v, entries, lengths = _inputs(b, e, hq, hkv, s, d)
    want = _jax(q, k, v, entries, lengths, "naive" if impl == "naive" else "blockwise",
                block)
    got = _port(q, k, v, entries, lengths, impl, block)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[2] == 0).all()                      # src_len 0: an exact 0
    if impl == "kernel":                            # the wrapper's CPU route
        np.testing.assert_array_equal(got, _port(q, k, v, entries, lengths, "blockwise",
                                                 512))


@pytest.mark.parametrize("case", CASES[:2], ids=["g1", "gqa"])
def test_pooled_bf16_and_int8_pools_vs_reference(case):
    b, e, hq, hkv, s, d, block = case
    q, k, v, entries, lengths = _inputs(b, e, hq, hkv, s, d)
    # bf16 pool (and q)
    q16, k16, v16 = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    want = _jax(q16, k16, v16, entries, lengths, "blockwise", block)
    got = _port(q16, k16, v16, entries, lengths, "kernel", block)
    np.testing.assert_allclose(got, want, atol=2e-2)
    # int8 pool, bf16 scales [E, Hkv, S]
    kq, ks = jax_quantize_kv(jnp.asarray(k))
    vq, vs = jax_quantize_kv(jnp.asarray(v))
    scales = {"k_scale": np.asarray(jnp.swapaxes(ks, 1, 2).astype(jnp.bfloat16)),
              "v_scale": np.asarray(jnp.swapaxes(vs, 1, 2).astype(jnp.bfloat16))}
    kq, vq = np.asarray(kq), np.asarray(vq)
    for impl in ("blockwise", "naive"):
        want = _jax(q, kq, vq, entries, lengths, impl, block, **scales)
        for port_impl in ((impl, "kernel") if impl == "blockwise" else (impl,)):
            got = _port(q, kq, vq, entries, lengths, port_impl, block, **scales)
            np.testing.assert_allclose(got, want, atol=2e-5, err_msg=port_impl)
            assert (got[2] == 0).all()


def test_pooled_equals_the_per_row_read_of_the_gathered_copy():
    """``swiftkv_decode_pooled`` on the pool is bitwise the blockwise read
    of ``pool[entries]``, int8 scales included."""
    b, e, hq, hkv, s, d = 4, 7, 8, 2, 70, 16
    q, k, v, entries, lengths = (_t(x) for x in _inputs(b, e, hq, hkv, s, d))
    qg = q.reshape(b, hkv, hq // hkv, d)
    idx = entries.long()
    got = swiftkv.swiftkv_decode_pooled(qg, k, v, entries, lengths, block_size=32)
    want = swiftkv.swiftkv_decode_blockwise(qg, k[idx], v[idx], lengths, block_size=32)
    assert torch.equal(got, want)
    ks, vs = (torch.rand(e, hkv, s) for _ in range(2))
    k8, v8 = (torch.randint(-127, 128, x.shape, dtype=torch.int8) for x in (k, v))
    got = swiftkv.swiftkv_decode_pooled(qg, k8, v8, entries, lengths, ks, vs, block_size=32)
    want = swiftkv.swiftkv_decode_blockwise(qg, k8[idx], v8[idx], lengths, ks[idx], vs[idx],
                                            block_size=32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("form", ["fold", "mma"])
def test_kernel_models_with_entries_bitwise_the_gathered_copy(form, n_split):
    """The plain models of both kernel files with ``entries=`` are the same
    models on the gathered copy, bit for bit, bf16 and int8 pools."""
    b, e, hq, hkv, s, d = 4, 7, 8, 2, 200, 16
    q, k, v, entries, lengths = (_t(x) for x in _inputs(b, e, hq, hkv, s, d))
    model = kref.swiftkv_decode_split_ref if form == "fold" else kref.swiftkv_decode_mma_ref
    idx = entries.long()
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got = model(q, k, v, lengths, n_split=n_split, entries=entries)
    assert torch.equal(got, model(q, k[idx], v[idx], lengths, n_split=n_split))
    assert (got[2] == 0).all()
    ks, vs = (torch.rand(e, hkv, s).to(torch.bfloat16) for _ in range(2))
    k8, v8 = (torch.randint(-127, 128, x.shape, dtype=torch.int8) for x in (k, v))
    got = model(q, k8, v8, lengths, n_split=n_split, k_scale=ks, v_scale=vs, entries=entries)
    want = model(q, k8[idx], v8[idx], lengths, n_split=n_split, k_scale=ks[idx],
                 v_scale=vs[idx])
    assert torch.equal(got, want)
    # in float32 the model's fold agrees with the dense oracle with entries
    qf, kf, vf = q.float(), k.float(), v.float()
    dense = kref.swiftkv_decode_ref(qf, kf, vf, lengths, entries=entries)
    fold = model(qf, kf, vf, lengths, n_split=n_split, entries=entries)
    np.testing.assert_allclose(fold.numpy(), dense.numpy(), atol=2e-5)


def test_wrapper_pooled_argument_checks():
    """A pooled read has no window, ring or LUT form (the reference's
    pooled read has none), on any device."""
    q, k, v, entries, lengths = (_t(x) for x in _inputs(4, 7, 4, 4, 40, 16))
    for kw in ({"window": 8}, {"ring": True, "window": 8}, {"exp_mode": "lut"}):
        with pytest.raises(ValueError, match="pooled"):
            ops.swiftkv_decode(q, k, v, lengths, entries=entries, **kw)
    out = ops.swiftkv_decode(q, k, v, lengths, entries=entries)
    assert out.shape == q.shape and (out[2] == 0).all()
    assert {"swiftkv_decode_pooled", "swiftkv_decode_pooled_int8"} <= set(LAUNCHES)


@pytest.mark.parametrize("source,argtypes", [("swiftkv_decode.cu", "LAUNCHER_ARGTYPES"),
                                             ("swiftkv_decode_mma.cu", "MMA_ARGTYPES")])
def test_launcher_argtypes_match_the_cuda_source(source, argtypes):
    """The ctypes argument types of each decode launcher match its C
    signature, the ``entries`` pointer included (a pointer passed as an int
    would be cut to 32 bits, a float as an int misread)."""
    src = (Path(ops.__file__).resolve().parents[2] / "csrc" / source).read_text()
    sigs = dict(re.findall(r'extern "C" int (swiftkv_decode\w*_launch)\(([^)]*)\)', src))
    (params,) = sigs.values()
    names = [p.split()[-1].lstrip("*") for p in (x.strip() for x in params.split(","))]
    assert names[3:5] == ["lengths", "entries"]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in (x.strip() for x in params.split(","))]
    assert getattr(ops, argtypes) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_source_pool_matches_reference(seed):
    """A random acquire/release sequence over a few source ids: the same
    entries, freshness, freed entries, refcounts and counters as the
    reference's ``SourceKVPool``."""
    rng = np.random.default_rng(seed)
    mine, theirs = SourceKVPool(4, 32), JaxSourceKVPool(4, 32)
    held = []
    for _ in range(200):
        if held and (rng.random() < 0.45 or mine.n_free == 0):
            sid = held.pop(int(rng.integers(len(held))))
            assert mine.release(sid) == theirs.release(sid)
        else:
            sid = int(rng.integers(6))
            got = mine.acquire(sid)
            assert got == theirs.acquire(sid)
            if got[0] is not None:
                held.append(sid)
        assert [mine.refcount(e) for e in range(4)] == [theirs.refcount(e) for e in range(4)]
        assert (mine.n_free, mine.total_ingests, mine.total_shares) == \
            (theirs.n_free, theirs.total_ingests, theirs.total_shares)
        mine.assert_consistent()
    mine.reset_stats()
    theirs.reset_stats()
    assert (mine.total_ingests, mine.total_shares) == (theirs.total_ingests,
                                                       theirs.total_shares)
