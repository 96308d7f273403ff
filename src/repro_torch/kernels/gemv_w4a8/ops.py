"""Wrapper of the W4A8 kernels (``csrc/gemv_w4a8.cu``): float activations
in, per-token int8 quantization, packed int4 weights with group scales,
float32 out.

CUDA tensors launch a hand-written kernel (or raise); CPU tensors run the
plain version in ``ref.py``. There is no fallback from one to the other.
The form follows M, the rows of ``x.reshape(-1, K)``:

* M <= 8 (decode): one launch of the decode form, which quantizes the rows
  itself. Its grid, from :func:`decode_plan` (shapes and SM count only, so
  it launches under CUDA-graph capture), is N tiles x ``ks`` CTAs along K,
  the ``ks`` CTAs of a tile forming one thread-block cluster that merges
  their partial sums in rank order.
* M > 8 (prefill): ``quantize_a8`` in plain torch here, then the kernel on
  the int8 codes, and a split-K reduce launch when K is split.

The kernels mask the ragged K and M edges themselves, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import GROUP, quantize_a8
from repro_torch.kernels import LAUNCHES, _build
from . import ref

TILE_N = 256       # output channels per CTA (csrc/gemv_w4a8.cu kTileN)
BLOCK_M = 8        # activation rows per CTA (kBM)
WARPS = 4          # warps per CTA, each taking its own groups of K

DECODE_MAX_M = 8                  # rows the decode form takes (kMaxM)
TILE_BYTES = (128, 64, 32, 16)    # weight bytes of a row per decode CTA, widest first
MAX_RANKS = 8                     # decode CTAs along K: one cluster (kMaxRanks)
_X_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("gemv_w4a8").gemv_w4a8_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _decode_launcher():
    fn = _build.load("gemv_w4a8").gemv_w4a8_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(m: int, k: int, n: int, sm_count: int) -> int:
    """CTAs along K: enough for ~2 CTAs per SM when the N x M tiles alone
    are fewer, never more than one group per warp."""
    tiles = -(-n // TILE_N) * -(-m // BLOCK_M)
    n_groups = -(-k // GROUP)
    return max(1, min(-(-n_groups // WARPS), (2 * sm_count) // tiles))


def decode_plan(m: int, k: int, n: int, sm_count: int) -> tuple[int, int]:
    """Grid of the decode form: (tile_bytes, ks), from shapes and the SM
    count only. ks is the most CTAs along K a cluster takes (MAX_RANKS, at
    most one per 128-row group): a shorter K slice shortens each CTA's
    quantization of x and its start-up. The tile is the widest whose tiles
    x ks fill the SMs at least once (wider tiles read longer runs of each
    weight row and quantize x fewer times); a shape too small to fill them
    gets the narrowest. ``m`` does not change the grid (every CTA takes
    all rows)."""
    ks = min(MAX_RANKS, -(-k // GROUP))
    for tile_bytes in TILE_BYTES:
        if -(-(n // 2) // tile_bytes) * ks >= sm_count:
            break
    return tile_bytes, ks


def launch_decode(x: torch.Tensor, packed: torch.Tensor, w_scale: torch.Tensor, *,
                  tile_bytes: int | None = None, ks: int | None = None,
                  scales_out: torch.Tensor | None = None) -> torch.Tensor:
    """The decode form on CUDA tensors: x [M <= 8, K] f32 or bf16 ->
    [M, N] f32, with :func:`decode_plan`'s grid unless ``tile_bytes`` /
    ``ks`` are given. ``scales_out`` ([M] f32) receives the row scales the
    kernel quantized with. Checks of ``packed`` / ``w_scale`` are the
    caller's (:func:`gemv_w4a8`)."""
    m, k = x.shape
    n = packed.shape[1] * 2
    if not 1 <= m <= DECODE_MAX_M:
        raise ValueError(f"gemv_w4a8: the decode form takes 1..{DECODE_MAX_M} rows, got {m}")
    if x.dtype not in _X_DTYPE_CODE:
        raise TypeError(f"gemv_w4a8: the decode form takes f32 or bf16 x, got {x.dtype}")
    plan = decode_plan(m, k, n, _sm_count(x.device.index))
    tile_bytes = tile_bytes or plan[0]
    ks = ks or plan[1]
    if tile_bytes not in TILE_BYTES or not 1 <= ks <= min(MAX_RANKS, -(-k // GROUP)):
        raise ValueError(f"gemv_w4a8: tile_bytes {tile_bytes} not in {TILE_BYTES} or "
                         f"ks {ks} not in 1..min({MAX_RANKS}, groups of K)")
    if scales_out is not None and (scales_out.dtype != torch.float32
                                   or scales_out.numel() < m or not scales_out.is_cuda):
        raise ValueError("gemv_w4a8: scales_out must be a CUDA f32 tensor of >= M")
    x = x.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    code = _decode_launcher()(
        x.data_ptr(), packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        scales_out.data_ptr() if scales_out is not None else None,
        m, k, n, _X_DTYPE_CODE[x.dtype], tile_bytes, ks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("gemv_w4a8", code)
    LAUNCHES["gemv_w4a8_decode"] += 1
    return out


def gemv_w4a8(x: torch.Tensor, packed: torch.Tensor,
              w_scale: torch.Tensor) -> torch.Tensor:
    """x: [..., K] float; packed: [K, N//2] uint8; w_scale: [ceil(K/128), N]
    f32 (group-wise, see quantization.quantize_w4). Returns [..., N] f32."""
    if not x.is_cuda:
        return ref.gemv_w4a8_ref(x, packed, w_scale)
    lead, k = x.shape[:-1], x.shape[-1]
    n = packed.shape[1] * 2
    if packed.shape[0] != k or packed.dtype != torch.uint8:
        raise ValueError(f"gemv_w4a8: packed must be [K={k}, N/2] uint8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if (w_scale.dtype != torch.float32 or w_scale.shape[1] != n
            or w_scale.shape[0] < -(-k // GROUP)):
        raise ValueError("gemv_w4a8: w_scale must be [ceil(K/128), N] f32")
    if n % 8:
        raise ValueError(f"gemv_w4a8: the kernel takes N a multiple of 8, got {n}")
    if not (packed.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("gemv_w4a8: packed weight and scales must be contiguous")
    if packed.data_ptr() % 4 or w_scale.data_ptr() % 16:
        raise ValueError("gemv_w4a8: packed weight must be 4-byte and scales "
                         "16-byte aligned")
    if packed.device != x.device or w_scale.device != x.device:
        raise ValueError("gemv_w4a8: all tensors must be on one device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("gemv_w4a8: tensors must be on the current device")
    if x.numel() // k <= DECODE_MAX_M:
        return launch_decode(x.reshape(-1, k), packed, w_scale).reshape(*lead, n)
    xq, xs = quantize_a8(x.reshape(-1, k))          # [M, K] int8, [M, 1] f32
    xq, xs = xq.contiguous(), xs.contiguous()
    m = xq.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ks = split_k(m, k, n, _sm_count(x.device.index))
    part = (torch.empty((ks, m, n), dtype=torch.float32, device=x.device)
            if ks > 1 else None)
    code = _launcher()(
        xq.data_ptr(), packed.data_ptr(), xs.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        m, k, n, ks, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("gemv_w4a8", code)
    LAUNCHES["gemv_w4a8"] += 1
    if ks > 1:                  # the launcher then also ran its split-K reduce
        LAUNCHES["gemv_w4a8_reduce"] += 1
    return out.reshape(*lead, n)

