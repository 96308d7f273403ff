"""Wrapper of the SwiftKV decode kernel (``csrc/swiftkv_decode.cu``).

CUDA tensors launch the hand-written kernel (or raise); CPU tensors run the
plain version in ``ref.py``. There is no fallback from one to the other.
The kernel reads the cache in its native ``[B, S, Hkv, D]`` layout, so the
wrapper never copies it; unlike the TPU wrapper it has no block-size
contract (the kernel picks its own tile and masks the ragged edge).

The kernel splits each (row, KV head)'s positions over ``n_split`` CTAs of
one thread-block cluster, which merge their partial (mu, Z, Y) states in
split order inside the launch. ``n_split`` comes from :func:`split_count`,
one policy for both kernels: a model of the launch's waves and of the
bytes its resident CTAs keep in flight, from shapes, dtypes and the
card's occupancy of the kernel instance (:func:`occupancy`: CTAs per SM
and resident clusters of each size, asked once per instance and kept).
It reads no lengths and no device value per launch, so a launch is
capturable in a CUDA graph once the instance has launched eagerly.

``ring=True`` reads a ring cache of R = S slots in place: the kernel cuts
the window's positions into the same tiles and splits as the linear form
and reads position ``t`` at slot ``t mod S``, so on the same positions the
two forms give the same bits.

``exp_mode="lut"`` takes the paper's Eq. 9-10 exponential for every
exponential of the fold and merges, in every form (linear, window, ring,
int8): the launcher passes the table, which the wrapper makes from
``make_lut`` (:func:`lut_table`), and runs the kernel's LUT instance.

``entries=`` reads a shared source-KV pool (cross attention in continuous
serving): k/v are ``[E, S, Hkv, D]`` (int8 scales ``[E, Hkv, S]``) and row
``b`` reads entry ``entries[b]`` in place; each kernel form changes only
the base address of a row's cache and scale planes, so on the same bytes
the pooled read is bit for bit the read of the gathered copy
``k[entries]``. Cross reads have no window, ring or LUT form.

Two kernels compute the function (:func:`kernel_form`, from shapes and
dtypes only): ``"mma"``, the GQA form on tensor cores
(``csrc/swiftkv_decode_mma.cu``: a bf16 q, a bf16 or int8 cache, the
native exponential, 2 <= G <= 8, D a multiple of 16); and ``"fold"``,
``csrc/swiftkv_decode.cu``, for everything else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.exp2_lut import lut_tensors
from repro_torch.core.swiftkv import swiftkv_decode_pooled
from repro_torch.kernels import LAUNCHES, _build
from . import ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_GROUP = 8       # query heads per KV head the kernel takes
MAX_HEAD_DIM = 256
TILE = ref.TILE     # positions per CTA step: the splits are cut in whole tiles
MAX_SPLIT = 8       # CTAs per cluster (the portable cluster size)
MMA_TILE = ref.MMA_TILE   # the GQA form's positions per CTA step
# split_count's two constants, fitted to the n_split sweeps of
# tools/swiftkv_split_sweep.py on an H100 by tools/swiftkv_split_fit.py
SATURATION_BYTES = 2.4e6  # tile bytes in flight that reach the memory's rate
MERGE_TILES = {"fold": 0.5, "mma": 0.2}   # a CTA more in a cluster, in tile times


def kernel_form(g: int, d: int, q_dtype: torch.dtype, kv_dtype: torch.dtype,
                exp_mode: str = "native") -> str:
    """Which kernel computes a call, from shapes and dtypes only (never
    lengths, so a launch stays capturable): ``"mma"``, the GQA form on
    tensor cores, for a bf16 q against a bf16 or int8 cache with the
    native exponential, 2 <= G <= 8 and D a multiple of 16 up to 256;
    ``"fold"`` otherwise (G = 1, an f32 q or cache, every LUT call, D not a
    multiple of 16), bit for bit the kernel of earlier PRs."""
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and exp_mode == "native" and 2 <= g <= MAX_GROUP and d % 16 == 0
            and d <= MAX_HEAD_DIM):
        return "mma"
    return "fold"


def split_tiles(s_len: int, window: int | None, form: str) -> int:
    """T, the most tiles of the form (``MMA_TILE`` positions for the GQA
    form, ``TILE`` for the fold) that a row's positions can span: the
    ``min(S, window)`` positions a row can attend, plus one where a window
    shorter than the cache may start inside a tile. From S and the window
    only, so a ring and its linear twin with the same window agree."""
    n_pos = min(s_len, window) if window else s_len
    return -(-n_pos // (MMA_TILE if form == "mma" else TILE)) + bool(window and window < s_len)


def split_count(pairs: int, tiles: int, tile_bytes: int, clusters, form: str) -> int:
    """CTAs that share one (row, KV head): the n in 1..min(T, MAX_SPLIT)
    of least modelled time. ``pairs`` P = B x Hkv clusters of n CTAs run in
    ``ceil(P / clusters[n - 1])`` waves (``clusters``: the card's resident
    clusters of n = 1..MAX_SPLIT CTAs of this kernel instance,
    :func:`occupancy`); each CTA folds its chunk of ``ceil(T / n)`` tiles
    of ``tile_bytes`` bytes, one tile time each while the wave's resident
    CTAs keep fewer than ``SATURATION_BYTES`` of tiles in flight, stretched
    in proportion beyond, when the memory's rate holds them back; each CTA
    past the first adds ``MERGE_TILES[form]`` tile times (start-up and the
    cluster merge). Both constants are fitted to n_split sweeps on an H100
    (``tools/swiftkv_split_fit.py``, PERF.md §6). Reads no lengths and no
    device value, so a launch stays capturable."""
    best, best_cost = 0, float("inf")
    for n in range(1, min(tiles, MAX_SPLIT) + 1):
        if clusters[n - 1] < 1:
            continue
        waves = -(-pairs // clusters[n - 1])
        in_flight = min(pairs, clusters[n - 1]) * n * tile_bytes
        cost = (waves * -(-tiles // n) * max(1.0, in_flight / SATURATION_BYTES)
                + MERGE_TILES[form] * (n - 1))
        if cost < best_cost:
            best, best_cost = n, cost
    if not best:
        raise RuntimeError("swiftkv_decode: the card holds no cluster of this kernel instance")
    return best


def split_plan(q: torch.Tensor, k: torch.Tensor, window: int | None = None, *,
               k_scale: torch.Tensor | None = None, exp_mode: str = "native",
               form: str | None = None) -> int:
    """The n_split that :func:`launch` takes for these CUDA tensors by
    default: :func:`split_count` from shapes, dtypes and the kernel
    instance's :func:`occupancy`, asked of the card at the instance's first
    launch. Kept per shape, so a launch pays one dictionary lookup. S is
    the pool's rows with ``entries``."""
    b, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    return _split_plan(b, hkv, s_len, hq // hkv, d, window, q.dtype, k.dtype,
                       None if k_scale is None else k_scale.dtype, exp_mode == "lut", form,
                       q.device.index)


@functools.cache
def _split_plan(b, hkv, s_len, g, d, window, q_dtype, kv_dtype, scale_dtype, lut, form,
                device_index) -> int:
    form = form or kernel_form(g, d, q_dtype, kv_dtype, "lut" if lut else "native")
    _, clusters = occupancy(form, g, d, q_dtype, kv_dtype, scale_dtype, lut, device_index)
    tile = MMA_TILE if form == "mma" else TILE
    row_bytes = 2 * d * kv_dtype.itemsize + (0 if scale_dtype is None else 2 * scale_dtype.itemsize)
    return split_count(b * hkv, split_tiles(s_len, window, form), tile * row_bytes, clusters,
                       form)


# the C signature of csrc/swiftkv_decode.cu's launcher
LAUNCHER_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float]
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.cache
def _launcher():
    fn = _build.load("swiftkv_decode").swiftkv_decode_launch
    fn.argtypes = LAUNCHER_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


# the C signature of csrc/swiftkv_decode_mma.cu's launcher
MMA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.cache
def _mma_launcher():
    fn = _build.load("swiftkv_decode").swiftkv_decode_mma_launch
    fn.argtypes = MMA_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


# the C signatures of the two kernels' occupancy queries: the fold's
# (G, D, q, kv and scale dtype codes, LUT flag, out[9]) and the GQA form's
# (G, D, kv and scale dtype codes, out[9])
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]
MMA_OCCUPANCY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def occupancy(form: str, g: int, d: int, q_dtype: torch.dtype, kv_dtype: torch.dtype,
              scale_dtype: torch.dtype | None = None, lut: bool = False,
              device_index: int | None = None) -> tuple[int, tuple[int, ...]]:
    """What the card holds of one kernel instance, as :func:`launch`
    launches it (the same shared memory, block and clusters): its CTAs per
    SM and, for n = 1..MAX_SPLIT, how many clusters of n CTAs can be
    resident at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    ``cudaOccupancyMaxActiveClusters``). Asked of the card once per
    instance and device and kept; raises if the query fails."""
    lib = _build.load("swiftkv_decode")
    out = (ctypes.c_int * (MAX_SPLIT + 1))()
    scale_code = _DTYPE_CODE[scale_dtype] if scale_dtype is not None else 0
    with torch.cuda.device(torch.cuda.current_device() if device_index is None
                           else device_index):
        if form == "mma":
            fn = lib.swiftkv_decode_mma_occupancy
            fn.argtypes, fn.restype = MMA_OCCUPANCY_ARGTYPES, ctypes.c_int
            code = fn(g, d, _DTYPE_CODE[kv_dtype], scale_code, out)
        else:
            fn = lib.swiftkv_decode_occupancy
            fn.argtypes, fn.restype = OCCUPANCY_ARGTYPES, ctypes.c_int
            code = fn(g, d, _DTYPE_CODE[q_dtype], _DTYPE_CODE[kv_dtype], scale_code,
                      int(lut), out)
    _build.check("swiftkv_decode", code)
    return out[0], tuple(out[1:])


@functools.cache
def _exp_launcher():
    fn = _build.load("swiftkv_decode").swiftkv_exp_lut_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def lut_table(device: torch.device) -> torch.Tensor:
    """The LUT form's table on ``device``: make_lut's 32 values, then its
    32 slopes, float32 [64]. Made at the first LUT launch on a device
    (outside any CUDA-graph capture) and kept."""
    return torch.cat(lut_tensors(device)).contiguous()


def exp_lut(x: torch.Tensor) -> torch.Tensor:
    """The kernel's LUT exponential elementwise: on a CUDA float32 tensor
    the kernel's own device function (``swiftkv_exp_lut_launch``), on a CPU
    tensor its plain version ``ref.exp_lut_kernel``. A test entry: it
    holds the kernel's exponential bit for bit to the plain version."""
    if x.dtype != torch.float32:
        raise TypeError(f"exp_lut: float32 input, got {x.dtype}")
    if not x.is_cuda:
        return ref.exp_lut_kernel(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        code = _exp_launcher()(x.data_ptr(), lut_table(x.device).data_ptr(), out.data_ptr(),
                               x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
        _build.check("swiftkv_decode", code)
        LAUNCHES["swiftkv_exp_lut"] += 1
    return out


def swiftkv_decode(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, lengths: torch.Tensor, *,
                   window: int | None = None, scale: float | None = None,
                   exp_mode: str = "native", ring: bool = False,
                   k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None,
                   entries: torch.Tensor | None = None) -> torch.Tensor:
    """SwiftKV single-pass decode attention.

    q: [B, Hq, D]; k_cache/v_cache: [B, S, Hkv, D]; lengths: [B] int.
    Returns [B, Hq, D] in q.dtype. ``k_scale`` / ``v_scale``: optional
    [B, Hkv, S] f32/bf16 dequant scales of an int8 cache. ``ring``: the
    caches are rings of S slots and ``lengths`` counts the tokens seen (it
    may exceed S); needs ``window``. ``exp_mode``: ``"native"`` or
    ``"lut"`` (the paper's Eq. 9-10 exponential). ``entries``: [B] int, the
    caches are a pool [E, S, Hkv, D] (scales [E, Hkv, S]) and row ``b``
    reads entry ``entries[b]`` (each in [0, E): the caller's contract) up
    to ``lengths[b]``, the entry's valid prefix; on CPU tensors this runs
    :func:`swiftkv_decode_pooled`, the reference's blockwise pooled read."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("swiftkv_decode: pass both k_scale and v_scale "
                         "or neither")
    if ring and window is None:
        raise ValueError("swiftkv_decode: ring caches are windowed — pass "
                         "window with ring=True")
    if window is not None and window < 1:
        raise ValueError(f"swiftkv_decode: window must be >= 1, got {window}")
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"swiftkv_decode: Hq={hq} not a multiple of Hkv={hkv}")
    scale = float(1.0 / (d ** 0.5)) if scale is None else float(scale)
    if entries is not None:
        _check_pooled(window, ring, exp_mode)
        if not q.is_cuda:
            out = swiftkv_decode_pooled(q.reshape(b, hkv, hq // hkv, d), k_cache, v_cache,
                                        entries, lengths, k_scale, v_scale, scale=scale)
            return out.reshape(b, hq, d)
    if not q.is_cuda:
        return ref.swiftkv_decode_ref(q, k_cache, v_cache, lengths,
                                      window=window, scale=scale, ring=ring,
                                      exp_mode=exp_mode, k_scale=k_scale,
                                      v_scale=v_scale)
    return launch(q, k_cache, v_cache, lengths, window=window, scale=scale,
                  ring=ring, exp_mode=exp_mode, k_scale=k_scale, v_scale=v_scale,
                  entries=entries)


def _check_pooled(window, ring, exp_mode) -> None:
    if ring or window is not None or exp_mode != "native":
        raise ValueError("swiftkv_decode: a pooled read (entries=) has no window, "
                         "ring or LUT form")


def launch(q, k, v, lengths, *, window=None, scale=None, ring=False, exp_mode="native",
           k_scale=None, v_scale=None, n_split=None, form=None,
           entries=None) -> torch.Tensor:
    """Launch the kernel that :func:`kernel_form` picks on CUDA tensors
    (shapes as :func:`swiftkv_decode`) with ``n_split`` CTAs per (row, KV
    head), by default :func:`split_plan`'s. ``form="fold"`` forces the fold
    on a call the GQA form would take (a test and timing entry: the two
    side by side)."""
    pooled = entries is not None
    if pooled:
        _check_pooled(window, ring, exp_mode)
    if ring and not window:
        raise ValueError("swiftkv_decode: ring caches are windowed — pass "
                         "window with ring=True")
    b, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(1.0 / (d ** 0.5)) if scale is None else float(scale)
    quant = k_scale is not None
    n_rows = k.shape[0] if pooled else b       # pool entries, or the batch
    tensors = ([q, k, v, lengths] + ([k_scale, v_scale] if quant else [])
               + ([entries] if pooled else []))
    if any(t.device != q.device for t in tensors):
        raise ValueError("swiftkv_decode: all tensors must be on one device")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("swiftkv_decode: tensors must be on the current device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"swiftkv_decode: q dtype {q.dtype} (f32 or bf16)")
    if k.dtype != v.dtype or k.dtype not in _DTYPE_CODE or k.shape != v.shape:
        raise TypeError("swiftkv_decode: k and v must share a shape and a "
                        "dtype of f32, bf16 or int8")
    if (k.dtype == torch.int8) != quant:
        raise TypeError("swiftkv_decode: int8 caches take scales, float "
                        "caches take none")
    if (k.shape[0] != n_rows or k.shape[3] != d or lengths.shape != (b,)
            or (pooled and entries.shape != (b,))):
        raise ValueError("swiftkv_decode: shapes of q, caches, lengths and "
                         "entries disagree")
    if g > MAX_GROUP or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"swiftkv_decode: kernel takes G <= {MAX_GROUP} and "
                         f"D a multiple of 8 up to {MAX_HEAD_DIM}; got G={g}, "
                         f"D={d}")
    # the cache is read in place: no silent copy of it
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("swiftkv_decode: caches must be contiguous")
    if (k.data_ptr() | v.data_ptr()) % (8 * k.element_size()):
        raise ValueError("swiftkv_decode: caches must be aligned to 8 elements")
    scale_code = 0
    if quant:
        if (k_scale.shape != (n_rows, hkv, s_len) or v_scale.shape != k_scale.shape
                or k_scale.dtype != v_scale.dtype
                or k_scale.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError("swiftkv_decode: scales must be [B, Hkv, S] ([E, Hkv, S] "
                             "with entries) f32 or bf16, both alike")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        scale_code = _DTYPE_CODE[k_scale.dtype]
    if exp_mode not in ref.EXP_MODES:
        raise ValueError(f"swiftkv_decode: exp_mode must be 'native' or 'lut', "
                         f"got {exp_mode!r}")
    chosen = kernel_form(g, d, q.dtype, k.dtype, exp_mode)
    if form not in (None, "fold", chosen):
        raise ValueError(f"swiftkv_decode: form {form!r}: this call takes {chosen!r} "
                         "or 'fold'")
    form = form or chosen
    if n_split is None:
        n_split = split_plan(q, k, window, k_scale=k_scale, exp_mode=exp_mode, form=form)
    if not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"swiftkv_decode: n_split must be in 1..{MAX_SPLIT}")
    lut = exp_mode == "lut"
    q = q.contiguous()
    if form == "mma" and q.data_ptr() % 8:
        q = q.clone()               # the kernel reads q 8 bytes at a time
    lengths = lengths.to(torch.int32).contiguous()
    if pooled:
        entries = entries.to(torch.int32).contiguous()
    entries_ptr = entries.data_ptr() if pooled else None
    out = torch.empty_like(q)
    key = ("swiftkv_decode" + ("_pooled" if pooled else "") + ("_lut" if lut else "")
           + ("_ring" if ring else "") + ("_int8" if quant else ""))
    if form == "mma":
        code = _mma_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), entries_ptr,
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            out.data_ptr(), b, s_len, hkv, g, d, window or 0, int(ring), scale, n_split,
            _DTYPE_CODE[k.dtype], scale_code,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check("swiftkv_decode", code)
        LAUNCHES[key] += 1
        LAUNCHES["swiftkv_decode_mma"] += 1
        return out
    code = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), entries_ptr,
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        lut_table(q.device).data_ptr() if lut else None, out.data_ptr(),
        b, s_len, hkv, g, d, window or 0, int(ring), scale, n_split,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], scale_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("swiftkv_decode", code)
    LAUNCHES[key] += 1
    return out
