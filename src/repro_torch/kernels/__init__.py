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
    "swiftkv_decode_ring": 0,   # the ring form (ring=True), float cache
    "swiftkv_decode_ring_int8": 0,  # the ring form, int8 cache
    "swiftkv_decode_lut": 0,    # exp_mode="lut" (Eq. 9-10 exponential), float cache
    "swiftkv_decode_lut_int8": 0,
    "swiftkv_decode_lut_ring": 0,
    "swiftkv_decode_lut_ring_int8": 0,
    "swiftkv_decode_pooled": 0,  # entries=: a source-KV pool read per row
    "swiftkv_decode_pooled_int8": 0,  # the same, int8 pool
    "swiftkv_exp_lut": 0,       # the LUT exponential alone (a test entry)
    "swiftkv_decode_mma": 0,    # of the swiftkv_decode* launches above, those of
                                # the GQA form on tensor cores (ops.kernel_form)
    "gemv_w4a8_decode": 0,      # M <= 8: quantizes x itself, one launch
    "gemv_w4a8_quant": 0,       # M > 8: the rows' scales and int8 codes,
    "gemv_w4a8": 0,             # then the GEMM on them
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
