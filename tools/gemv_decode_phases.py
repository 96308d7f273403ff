#!/usr/bin/env python3
"""Where the decode form of the W4A8 kernel spends its cycles, phase by phase.

    python3 tools/gemv_decode_phases.py

Needs one NVIDIA GPU (Hopper) and the CUDA toolkit's nvcc, as
``chip_smoke.py`` does. It builds ``src/repro_torch/csrc/gemv_w4a8.cu``
with ``-DGEMV_DECODE_PHASES`` into ``build/repro_torch/``: the decode
kernel then writes each CTA's ``clock64()`` at its phase boundaries (into
the buffer that otherwise takes the row scales). For llama2-7b's decode
projections and qwen3-8b's K/V projection (M 8, bf16 x, the wrapper's
grid) it prints the mean and the largest cycles of each phase over the
CTAs of a call:

- x: from the start to this rank's row maxima (x's slice copied into
  shared memory, the first weight stage issued);
- scales: the cluster barrier of the maxima exchange (waiting for the
  slowest rank) and the rows' scales, while the ring's next stages go out;
- quantize: the slice's int8 codes;
- weights: the weight loop (tensor-core products over the ring);
- merge: the warps' and then the ranks' partial sums (one cluster barrier).

The cycles are the SMs' own; the card line says which card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("x", "scales", "quantize", "weights", "merge")
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 1024))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemv_decode_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.quantization import quantize_w4
    from repro_torch.kernels import _build
    from repro_torch.kernels.gemv_w4a8 import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[phases] {card}", flush=True)
    lib_path = _build.BUILD_DIR / "libgemv_w4a8-phases.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DGEMV_DECODE_PHASES", "-o",
                    str(lib_path), str(_build.SRC_DIR / "gemv_w4a8.cu")],
                   check=True, capture_output=True)
    launch = ctypes.CDLL(str(lib_path)).gemv_w4a8_decode_launch
    launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(4)
    for k, n in SHAPES:
        tile_bytes, ks = ops.decode_plan(8, k, n, sm_count)
        ctas = -(-(n // 2) // tile_bytes) * ks
        x = torch.randn(8, k, generator=gen, device="cuda").to(torch.bfloat16)
        weights = [quantize_w4(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
                   for _ in range(2)]
        out = torch.empty(8, n, device="cuda")
        clocks = torch.zeros(ctas * 6, dtype=torch.int64, device="cuda")
        for i in range(3):          # the last of three calls, on alternating weights
            qw = weights[i % 2]
            code = launch(x.data_ptr(), qw.packed.data_ptr(), qw.scale.data_ptr(),
                          out.data_ptr(), clocks.data_ptr(), 8, k, n, 1, tile_bytes, ks,
                          torch.cuda.current_stream().cuda_stream)
            _build.check("gemv_w4a8", code)
        torch.cuda.synchronize()
        c = clocks.view(ctas, 6).double()
        spans = c[:, 1:] - c[:, :-1]
        cols = ", ".join(f"{name} {spans[:, i].mean().item():.0f} / {spans[:, i].max().item():.0f}"
                         for i, name in enumerate(PHASES))
        print(f"[phases] M=8 K={k} N={n} (tile {tile_bytes} B, ks {ks}, {ctas} CTAs), cycles "
              f"mean / max over CTAs: {cols}; whole {c[:, 5].mean().item():.0f} / "
              f"{c[:, 5].max().item():.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
