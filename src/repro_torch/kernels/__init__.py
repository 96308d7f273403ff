"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel of
the reference, each beside its plain PyTorch version.

``LAUNCHES`` counts kernel launches by name: a wrapper adds one where it
launches its kernel on the GPU, and nowhere else (a CPU call runs the plain
version and counts nothing). ``chip_smoke.py`` zeroes the counts before it
drives the serving path and reads them after, to show the path went
through the kernels.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "swiftkv_decode": 0,        # float KV cache (f32 / bf16)
    "swiftkv_decode_int8": 0,   # int8 KV cache with per-position scales
    "gemv_w4a8_decode": 0,      # M <= 8: quantizes x itself, one launch
    "gemv_w4a8": 0,             # M > 8, on codes quantized in PyTorch
    "gemv_w4a8_reduce": 0,      # its split-K reduction, when K is split
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
