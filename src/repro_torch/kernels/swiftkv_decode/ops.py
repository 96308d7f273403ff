"""Wrapper of the SwiftKV decode kernel (``csrc/swiftkv_decode.cu``).

CUDA tensors launch the hand-written kernel (or raise); CPU tensors run the
plain version in ``ref.py``. There is no fallback from one to the other.
The kernel reads the cache in its native ``[B, S, Hkv, D]`` layout, so the
wrapper never copies it; unlike the TPU wrapper it has no block-size
contract (the kernel picks its own tile and masks the ragged edge).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build
from . import ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_GROUP = 8       # query heads per KV head the kernel takes
MAX_HEAD_DIM = 256


@functools.cache
def _launcher():
    fn = _build.load("swiftkv_decode").swiftkv_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def swiftkv_decode(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, lengths: torch.Tensor, *,
                   window: int | None = None, scale: float | None = None,
                   exp_mode: str = "native", ring: bool = False,
                   k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """SwiftKV single-pass decode attention.

    q: [B, Hq, D]; k_cache/v_cache: [B, S, Hkv, D]; lengths: [B] int.
    Returns [B, Hq, D] in q.dtype. ``k_scale`` / ``v_scale``: optional
    [B, Hkv, S] f32/bf16 dequant scales of an int8 cache. ``ring`` and
    ``exp_mode="lut"`` wait for their slice (ROADMAP §2)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("swiftkv_decode: pass both k_scale and v_scale "
                         "or neither")
    if ring and window is None:
        raise ValueError("swiftkv_decode: ring caches are windowed — pass "
                         "window with ring=True")
    if ring or exp_mode != "native":
        raise NotImplementedError(
            "swiftkv_decode: ring=True and exp_mode='lut' are not ported "
            "yet (ROADMAP §2)")
    if window is not None and window < 1:
        raise ValueError(f"swiftkv_decode: window must be >= 1, got {window}")
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"swiftkv_decode: Hq={hq} not a multiple of Hkv={hkv}")
    scale = float(1.0 / (d ** 0.5)) if scale is None else float(scale)
    if not q.is_cuda:
        return ref.swiftkv_decode_ref(q, k_cache, v_cache, lengths,
                                      window=window, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)
    return _launch(q, k_cache, v_cache, lengths, window, scale, k_scale, v_scale)


def _launch(q, k, v, lengths, window, scale, k_scale, v_scale):
    b, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    quant = k_scale is not None
    tensors = [q, k, v, lengths] + ([k_scale, v_scale] if quant else [])
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
    if k.shape[0] != b or k.shape[3] != d or lengths.shape != (b,):
        raise ValueError("swiftkv_decode: shapes of q, caches and lengths "
                         "disagree")
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
        if (k_scale.shape != (b, hkv, s_len) or v_scale.shape != k_scale.shape
                or k_scale.dtype != v_scale.dtype
                or k_scale.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError("swiftkv_decode: scales must be [B, Hkv, S] "
                             "f32 or bf16, both alike")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        scale_code = _DTYPE_CODE[k_scale.dtype]
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    code = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, out.data_ptr(),
        b, s_len, hkv, g, d, window or 0, scale,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], scale_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("swiftkv_decode", code)
    LAUNCHES["swiftkv_decode_int8" if quant else "swiftkv_decode"] += 1
    return out
