#!/usr/bin/env python3
"""Times the W4A8 wrapper's M > 8 (prefill) form of one or more trees of the
port on one card, in turns, on ``chip_smoke.py``'s timer.

    python3 tools/gemv_prefill_times.py [SRC ...]

Each SRC is the ``src`` directory of a checkout of the port (default: this
one's). Each is run in a subprocess of its own, in the order given (give
parent, change, change, parent to compare two trees on one card), which
builds its tree's kernels into that tree's ``build/`` and times one call
of ``repro_torch.kernels.gemv_w4a8.ops.gemv_w4a8`` (whatever form that
tree takes for M > 8, quantization included) at M 9, 16, 64, 100 and 1024
x llama2-7b's projections (4096 -> 4096, 4096 -> 11008, 11008 -> 4096) and
qwen3-8b's K/V (4096 -> 1024), bf16 x, random weights from a seed: device
time of a CUDA-graph replay, L2 flushed by a 256 MB write, median of 25
(``chip_smoke.Timer``). Prints one line per tree and shape, then a JSON
line of all times, then the card line. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MS = (9, 16, 64, 100, 1024)
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 1024))


def one(src: str) -> dict:
    """Times of the tree at ``src`` by 'M K N' (run in its own process)."""
    import torch
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer
    from repro_torch.core.quantization import quantize_w4
    from repro_torch.kernels import _build
    from repro_torch.kernels.gemv_w4a8 import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["gemv_w4a8"])
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    times = {}
    for k, n in SHAPES:
        qw = quantize_w4(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
        for m in MS:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            times[f"{m} {k} {n}"] = timer(lambda: ops.gemv_w4a8(x, qw.packed, qw.scale))
    return times


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gemv_prefill_times: no CUDA device", file=sys.stderr)
        return 1
    srcs = argv or [str(ROOT / "src")]
    results = []
    for src in srcs:
        res = subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve())],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, sep="\n", file=sys.stderr)
            return res.returncode
        times = json.loads(res.stdout.strip().splitlines()[-1])
        results.append({"src": src, "ms": times})
        for key, ms in times.items():
            m, k, n = key.split()
            print(f"[time] {src}: gemv_w4a8 M={m} K={k} N={n}: {ms:.4f} ms", flush=True)
    print(json.dumps(results))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
