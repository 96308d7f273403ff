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
* M > 8 (prefill): two launches. The quantize kernel writes the rows'
  scales and int8 codes (bit for bit ``quantize_a8``'s, in the MMA's k
  order, each row zero-padded to whole 128-row groups: ``ref.pack_codes``
  is its plain model); the GEMM runs on them on int8 tensor cores, one CTA
  per 128-channel x 64-token output tile (grid: :func:`prefill_plan`),
  with no split of K.

The kernels mask the ragged K, M and N edges themselves; only the codes
are padded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import GROUP, QuantizedLinear
from repro_torch.kernels import LAUNCHES, _build
from . import ref

PREFILL_TILE = (128, 64)          # output channels x tokens of a prefill CTA (kPreBN, kPreBM)
DECODE_MAX_M = 8                  # rows the decode form takes (kMaxM)
TILE_BYTES = (128, 64, 32, 16)    # weight bytes of a row per decode CTA, widest first
MAX_RANKS = 8                     # decode CTAs along K: one cluster (kMaxRanks)
_X_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of the launchers of csrc/gemv_w4a8.cu, in order
LAUNCHER_ARGTYPES = {
    "gemv_w4a8_quant_launch": [_P] * 3 + [_I] * 4 + [_P],
    "gemv_w4a8_launch": [_P] * 5 + [_I] * 4 + [_P],
    "gemv_w4a8_decode_launch": [_P] * 5 + [_I] * 6 + [_P],
}


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.load("gemv_w4a8"), name)
    fn.argtypes = LAUNCHER_ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def prefill_plan(m: int, n: int) -> tuple[int, int]:
    """Grid of the prefill form's GEMM, (N tiles, M tiles), as its launcher
    computes it: one CTA per PREFILL_TILE of the output, from shapes only
    (so it launches under CUDA-graph capture). One tile for every shape:
    narrower tiles, whose grids would cover more SMs at M <= 64, put fewer
    warps in a CTA and ran slower at every shape timed (PERF.md); a small M
    leaves SMs idle, for a split of K to fill (ROADMAP)."""
    return -(-n // PREFILL_TILE[0]), -(-m // PREFILL_TILE[1])


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
    code = _launcher("gemv_w4a8_decode_launch")(
        x.data_ptr(), packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        scales_out.data_ptr() if scales_out is not None else None,
        m, k, n, _X_DTYPE_CODE[x.dtype], tile_bytes, ks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("gemv_w4a8", code)
    LAUNCHES["gemv_w4a8_decode"] += 1
    return out


def launch_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill form's quantize kernel on a CUDA x [M, K] f32 or bf16:
    (codes [M, Kp] int8 in the MMA's k order, zero-padded to Kp = K rounded
    up to 128, as ``ref.pack_codes`` lays them out; scales [M] f32), bit
    for bit ``quantize_a8``'s."""
    if x.dtype not in _X_DTYPE_CODE:
        raise TypeError(f"gemv_w4a8: the prefill form takes f32 or bf16 x, got {x.dtype}")
    m, k = x.shape
    x = x.contiguous()
    kp = -(-k // GROUP) * GROUP
    codes = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    scales = torch.empty((m,), dtype=torch.float32, device=x.device)
    code = _launcher("gemv_w4a8_quant_launch")(x.data_ptr(), codes.data_ptr(), scales.data_ptr(), m, k, kp,
                             _X_DTYPE_CODE[x.dtype],
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("gemv_w4a8", code)
    LAUNCHES["gemv_w4a8_quant"] += 1
    return codes, scales


def launch_gemm(codes: torch.Tensor, scales: torch.Tensor, packed: torch.Tensor,
                w_scale: torch.Tensor, k: int) -> torch.Tensor:
    """The prefill form's GEMM on :func:`launch_quant`'s codes and scales
    -> [M, N] f32. Checks of ``packed`` / ``w_scale`` are the caller's."""
    m, kp = codes.shape
    n = packed.shape[1] * 2
    out = torch.empty((m, n), dtype=torch.float32, device=codes.device)
    code = _launcher("gemv_w4a8_launch")(
        codes.data_ptr(), packed.data_ptr(), scales.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, k, n, kp, torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("gemv_w4a8", code)
    LAUNCHES["gemv_w4a8"] += 1
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
    codes, scales = launch_quant(x.reshape(-1, k))
    return launch_gemm(codes, scales, packed, w_scale, k).reshape(*lead, n)


def linear_w4a8(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """A W4A8 linear layer: :func:`gemv_w4a8` of ``qw``'s packed weight and
    scales, plus its bias where it has one. [..., K] -> [..., N] f32 (a
    bias of another float type is added in f32). On a CUDA tensor the
    hand-written kernel runs (the decode form for M <= 8 rows, else the
    prefill form); on a CPU tensor its plain version."""
    out = gemv_w4a8(x, qw.packed, qw.scale)
    return out if qw.bias is None else out + qw.bias
