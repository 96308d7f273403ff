"""Wrapper of the W4A8 kernel (``csrc/gemv_w4a8.cu``): float activations
in, per-token int8 quantization here (plain torch, as the reference does it
outside its kernel), packed int4 weights with group scales, float32 out.

CUDA tensors launch the hand-written kernel (or raise); CPU tensors run the
plain version in ``ref.py``. There is no fallback from one to the other.
The kernel masks the ragged K and M edges itself, so nothing is padded.
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


@functools.cache
def _launcher():
    fn = _build.load("gemv_w4a8").gemv_w4a8_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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

