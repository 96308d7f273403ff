#!/usr/bin/env python3
"""Times the serving launcher of one or more trees of the port on one card,
in turns: the host cost of a change on the eager serving paths.

    python3 tools/serve_ab.py [SRC ...] [-- EXTRA ...]

Each SRC is the ``src`` directory of a checkout of the port (default: this
one's). Each is run in the order given (give parent, change, change,
parent to compare two trees on one card), in subprocesses of its own,
which build the tree's kernels into that tree's ``build/``:

* leg A's lock-step run: ``repro_torch.launch.serve --arch llama2-7b
  --batch 8 --prompt-len 512 --gen 64`` (full size, random bf16 weights,
  the kernel decode; ``ms_per_token_step`` is the wall clock of prefill
  plus 64 greedy steps over 64);
* leg C1's engine settings on the CLI's trace: ``--continuous --n-slots 8
  --max-len 1024 --chunk 128 --decode-ticks 8 --requests 16 --prompt-len
  512 --gen 64 --seed 7`` (tokens/s, TTFT and ITL percentiles).

``EXTRA`` is appended to every run (``-- --reduced --device cpu`` tries
the script on the CPU). Prints one line per tree and run, a JSON line of every result, then the
card's name and power limit. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = {
    "A lock-step": ["--arch", "llama2-7b", "--batch", "8", "--prompt-len", "512",
                    "--gen", "64"],
    "C1 continuous": ["--arch", "llama2-7b", "--continuous", "--n-slots", "8",
                      "--max-len", "1024", "--chunk", "128", "--decode-ticks", "8",
                      "--requests", "16", "--prompt-len", "512", "--gen", "64",
                      "--seed", "7"],
}
KEYS = {"A lock-step": ("ms_per_token_step", "tokens_per_s", "wall_s"),
        "C1 continuous": ("tokens_per_s", "wall_s", "ttft_p50_s", "itl_p50_ms",
                          "itl_effective_ms")}


def _run(src: str, args: list[str]) -> dict:
    env = dict(os.environ, PYTHONPATH=str(Path(src).resolve()))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         env=env, cwd=Path(src).resolve().parent, capture_output=True,
                         text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"{src} {args}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    srcs = argv[:argv.index("--")] if "--" in argv else argv
    results = []
    for src in srcs or [str(ROOT / "src")]:
        for name, args in RUNS.items():
            m = _run(src, args + extra)
            row = {"src": src, "run": name, **{k: m.get(k) for k in KEYS[name]}}
            results.append(row)
            print(f"{src:32s} {name:14s} " + "  ".join(f"{k} {m.get(k)}" for k in KEYS[name]),
                  flush=True)
    print(json.dumps(results))
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip())
    except FileNotFoundError:
        print("no nvidia-smi: no NVIDIA card")


if __name__ == "__main__":
    main()
