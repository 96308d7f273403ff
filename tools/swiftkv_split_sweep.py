#!/usr/bin/env python3
"""The split of ``swiftkv_decode`` over the CTAs of a cluster, on one card.

    python3 tools/swiftkv_split_sweep.py [--rounds R] [--out FILE.json]

For each shape of ``SHAPES`` (the twelve decode rows that ``chip_smoke.py``
times, then the same models at other batch sizes), prints the kernel
instance's occupancy (``ops.occupancy``: CTAs per SM, and the clusters of
n = 1..8 CTAs the card holds at once), the call's device time at every
n_split 1-8 (``ops.launch(n_split=)``; ``chip_smoke.Timer``: a CUDA-graph
replay after a 256 MB write flush of the L2, median of 25; ``--rounds``
passes over every shape, the median of the rounds kept) and the split that
``ops.split_plan`` picks, beside the sweep's best. ``--out`` writes every
record as JSON, the input of ``tools/swiftkv_split_fit.py`` (two such runs
are kept in ``tools/swiftkv_split_sweeps/``). Needs one NVIDIA GPU and
nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name: B, Hq, Hkv, S, D, length, int8, window, ring
SHAPES = {
    # chip_smoke.py's twelve swept rows (phase_timings)
    "llama2-7b len 576": (8, 32, 32, 640, 128, 576, False, None, False),
    "llama2-7b int8 len 192": (8, 32, 32, 256, 128, 192, True, None, False),
    "llama2-7b int8 len 576": (8, 32, 32, 640, 128, 576, True, None, False),
    "qwen3-8b GQA 32/8": (8, 32, 8, 640, 128, 576, False, None, False),
    "gemma-2b MQA": (8, 8, 1, 640, 256, 576, False, None, False),
    "danube ring": (8, 32, 8, 4224, 80, 4250, False, 4096, True),
    "danube ring int8": (8, 32, 8, 4224, 80, 4250, True, 4096, True),
    "danube window": (8, 32, 8, 4352, 80, 4250, False, 4096, False),
    "hymba ring": (8, 25, 5, 1152, 64, 1180, False, 1024, True),
    "hymba ring int8": (8, 25, 5, 1152, 64, 1180, True, 1024, True),
    "whisper cross": (8, 12, 12, 1500, 64, 1500, False, None, False),
    "vision cross": (8, 64, 8, 1600, 128, 1600, False, None, False),
    # the same models at other batch sizes
    "llama2-7b len 576 B1": (1, 32, 32, 640, 128, 576, False, None, False),
    "llama2-7b len 576 B2": (2, 32, 32, 640, 128, 576, False, None, False),
    "llama2-7b len 576 B4": (4, 32, 32, 640, 128, 576, False, None, False),
    "llama2-7b int8 len 576 B2": (2, 32, 32, 640, 128, 576, True, None, False),
    "qwen3-8b GQA 32/8 B1": (1, 32, 8, 640, 128, 576, False, None, False),
    "qwen3-8b GQA 32/8 B4": (4, 32, 8, 640, 128, 576, False, None, False),
    "qwen3-8b GQA 32/8 B16": (16, 32, 8, 640, 128, 576, False, None, False),
    "gemma-2b MQA B1": (1, 8, 1, 640, 256, 576, False, None, False),
    "gemma-2b MQA B2": (2, 8, 1, 640, 256, 576, False, None, False),
    "gemma-2b MQA B4": (4, 8, 1, 640, 256, 576, False, None, False),
    "gemma-2b MQA B16": (16, 8, 1, 640, 256, 576, False, None, False),
    "gemma-2b MQA B32": (32, 8, 1, 640, 256, 576, False, None, False),
    "danube ring B4": (4, 32, 8, 4224, 80, 4250, False, 4096, True),
    "danube ring int8 B4": (4, 32, 8, 4224, 80, 4250, True, 4096, True),
    "hymba ring B4": (4, 25, 5, 1152, 64, 1180, False, 1024, True),
    "whisper cross B1": (1, 12, 12, 1500, 64, 1500, False, None, False),
    "whisper cross B2": (2, 12, 12, 1500, 64, 1500, False, None, False),
    "whisper cross B4": (4, 12, 12, 1500, 64, 1500, False, None, False),
    "whisper cross B16": (16, 12, 12, 1500, 64, 1500, False, None, False),
    "vision cross B1": (1, 64, 8, 1600, 128, 1600, False, None, False),
    "vision cross B4": (4, 64, 8, 1600, 128, 1600, False, None, False),
    "vision cross int8": (8, 64, 8, 1600, 128, 1600, True, None, False),
    # other served shapes, held out of the fit: olmoe-1b-7b, llama4-scout's
    # heads, legs C1 / C2 at 1024 slots, whisper's self reads, longer caches,
    # legs E and L (4 slots) and f32 scales
    "olmoe-1b-7b len 576": (8, 16, 16, 640, 128, 576, False, None, False),
    "llama4-scout GQA 40/8": (8, 40, 8, 640, 128, 576, False, None, False),
    "llama2-7b S 1024 len 700": (8, 32, 32, 1024, 128, 700, False, None, False),
    "llama2-7b int8 S 1024 len 700": (8, 32, 32, 1024, 128, 700, True, None, False),
    "whisper self S 448 len 128": (8, 12, 12, 448, 64, 128, False, None, False),
    "gemma-2b MQA S 2048": (8, 8, 1, 2048, 256, 2000, False, None, False),
    "qwen3-8b GQA S 4096": (8, 32, 8, 4096, 128, 4000, False, None, False),
    "mistral-nemo GQA B2": (2, 32, 8, 640, 128, 576, False, None, False),
    "danube ring R 6144 B4": (4, 32, 8, 6144, 80, 5000, False, 4096, True),
    "hymba ring R 2048 B4": (4, 25, 5, 2048, 64, 1500, False, 1024, True),
    "vision cross B2": (2, 64, 8, 1600, 128, 1600, False, None, False),
    "whisper cross B8 len 750": (8, 12, 12, 1500, 64, 750, False, None, False),
}

HELD_OUT = tuple(SHAPES)[34:]


def sweep(rounds: int) -> list[dict]:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer, _swiftkv_inputs
    from repro_torch.kernels.swiftkv_decode import ops
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for name, (b, hq, hkv, s, d, length, int8, window, ring) in SHAPES.items():
        q, k, v, lens, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, torch.bfloat16,
                                            int8=int8, lengths=[length] * b)
        kw.update(window=window, ring=ring)
        form = ops.kernel_form(hq // hkv, d, q.dtype, k.dtype)
        ctas_per_sm, clusters = ops.occupancy(form, hq // hkv, d, q.dtype, k.dtype,
                                              kw["k_scale"].dtype if int8 else None)
        tile = ops.MMA_TILE if form == "mma" else ops.TILE
        cases.append({"name": name, "shape": [b, hq, hkv, s, d, length, int8, window, ring],
                      "form": form, "pairs": b * hkv,
                      "tiles": ops.split_tiles(s, window, form),
                      "tile_bytes": tile * (2 * d * k.element_size() + (4 if int8 else 0)),
                      "held_out": name in HELD_OUT,
                      "sm_count": sm_count, "ctas_per_sm": ctas_per_sm,
                      "clusters": list(clusters),
                      "pick": ops.split_plan(q, k, window, k_scale=kw.get("k_scale")),
                      "ms": {n: [] for n in range(1, ops.MAX_SPLIT + 1)},
                      "inputs": (q, k, v, lens, kw)})
    for _ in range(rounds):
        for case in cases:
            q, k, v, lens, kw = case["inputs"]
            for n in case["ms"]:
                case["ms"][n].append(timer(lambda n=n: ops.launch(q, k, v, lens, n_split=n,
                                                                   **kw)))
    for case in cases:
        del case["inputs"]
        case["ms"] = {n: statistics.median(t) for n, t in case["ms"].items()}
    return cases


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("swiftkv_split_sweep: no CUDA device; this tool needs one GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    cases = sweep(args.rounds)
    for c in cases:
        best = min(c["ms"], key=c["ms"].get)
        print(f"[sweep] {c['name']} ({c['form']} form, {c['pairs']} pairs, {c['tiles']} tiles "
              f"of {c['tile_bytes']} B; {c['ctas_per_sm']} CTAs per SM, clusters by n "
              f"{c['clusters']}): by n_split "
              + ", ".join(f"{n}: {t:.4f}" for n, t in c["ms"].items())
              + f"; best {best}, policy {c['pick']} "
              f"({c['ms'][c['pick']] / c['ms'][best]:.3f}x the best)", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card.stdout.strip(), "cases": cases}, indent=1))
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
