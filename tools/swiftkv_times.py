#!/usr/bin/env python3
"""Times ``swiftkv_decode`` of one or more trees of the port on one card, in
turns, and checks, kernel form by kernel form, that their outputs are bit
for bit the same.

    python3 tools/swiftkv_times.py [SRC ...]

Each SRC is the ``src`` directory of a checkout of the port (default: this
one's). Each is run in a subprocess of its own, in the order given (give
parent, change, change, parent to compare two trees on one card), which
builds its tree's kernels into that tree's ``build/`` and times one call of
``repro_torch.kernels.swiftkv_decode.ops.swiftkv_decode`` (native
exponential) at ``chip_smoke.py``'s seven native shapes (bf16; device time
of a CUDA-graph replay, L2 flushed by a 256 MB write, median of 25,
``chip_smoke.Timer``), its LUT form (``exp_mode="lut"``) where the tree has
one, and, where the tree can force it (``ops.launch(form="fold")``), the
fold on the shapes this tree's ``ops.kernel_form`` gives the GQA form. It
also runs ``ops.launch`` at every n_split 1-8 on seeded f32 and bf16 inputs
(linear, windowed, int8, ring; lengths 0 to 3R + 5; native and LUT) and
hashes the outputs' bytes, one hash per kernel form that this tree's
``ops.kernel_form`` gives the case ("fold" or "mma"; an older tree runs
every case on the fold). Prints one line per tree and shape, whether every
tree's hash of each form is the same, a JSON line of all results, then the
card line. Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name: B, Hq, Hkv, S, D, length, int8, window, ring (chip_smoke's rows)
SHAPES = {
    "len 576": (8, 32, 32, 640, 128, 576, False, None, False),
    "int8 len 192": (8, 32, 32, 256, 128, 192, True, None, False),
    "int8 len 576": (8, 32, 32, 640, 128, 576, True, None, False),
    "GQA 32/8 len 576": (8, 32, 8, 640, 128, 576, False, None, False),
    "ring R 4224 len 4250": (8, 32, 8, 4224, 80, 4250, False, 4096, True),
    "ring int8 R 4224 len 4250": (8, 32, 8, 4224, 80, 4250, True, 4096, True),
    "window 4096 S 4352 len 4250": (8, 32, 8, 4352, 80, 4250, False, 4096, False),
}
# B, Hq, Hkv, S, D, dtype, int8, window, ring, lengths, exp_mode: the bitwise cases
CASES = [
    (5, 8, 2, 256, 128, "float32", False, None, False, [0, 1, 31, 32, 256], "native"),
    (4, 64, 8, 256, 128, "float32", False, 100, False, [256, 200, 77, 1], "native"),
    (3, 4, 2, 96, 24, "float32", True, 40, False, [0, 50, 96], "native"),
    (8, 32, 8, 128, 80, "float32", True, 100, True, [0, 1, 99, 101, 127, 128, 129, 389],
     "native"),
    (8, 32, 32, 640, 128, "bfloat16", False, None, False, [576] * 6 + [1, 0], "native"),
    (8, 32, 32, 256, 128, "bfloat16", True, None, False, [192] * 6 + [1, 0], "native"),
    (8, 32, 8, 4224, 80, "bfloat16", False, 4096, True,
     [4161, 4224, 4225, 4250, 4288, 8453, 1, 0], "native"),
    (8, 32, 8, 4224, 80, "bfloat16", True, 4096, True,
     [4161, 4224, 4225, 4250, 4288, 8453, 1, 0], "native"),
    (8, 32, 8, 640, 128, "bfloat16", False, None, False, [576] * 6 + [1, 0], "native"),
    (5, 8, 2, 256, 128, "float32", False, None, False, [0, 1, 31, 32, 256], "lut"),
    (8, 32, 8, 4224, 80, "bfloat16", True, 4096, True,
     [4161, 4224, 4225, 4250, 4288, 8453, 1, 0], "lut"),
]


def labels() -> list[str]:
    """Each case's kernel form under this tree's rule."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.swiftkv_decode import ops
    return [ops.kernel_form(hq // hkv, d, getattr(torch, dt),
                            torch.int8 if int8 else getattr(torch, dt), mode)
            for b, hq, hkv, s, d, dt, int8, window, ring, lens, mode in CASES]


def one(src: str, forms: list[str]) -> dict:
    """Times by shape and the outputs' hash by form of the tree at ``src``
    (run in its own process)."""
    import torch
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer, _swiftkv_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.swiftkv_decode import ops
    _build.build(["swiftkv_decode"])
    timer = Timer(torch)
    params = inspect.signature(ops.launch).parameters
    digests = {form: hashlib.sha256() for form in set(forms)}
    for i, (b, hq, hkv, s, d, dt, int8, window, ring, lens, mode) in enumerate(CASES):
        if mode != "native" and "exp_mode" not in params:
            continue
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d,
                                               getattr(torch, dt), int8=int8, lengths=lens)
        if mode != "native":
            kw["exp_mode"] = mode
        for n_split in range(1, ops.MAX_SPLIT + 1):
            out = ops.launch(q, k, v, lengths, window=window, ring=ring, n_split=n_split, **kw)
            digests[forms[i]].update(out.float().cpu().numpy().tobytes())
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    modes = ["native"] + (["lut"] if "exp_mode" in params else [])
    for name, (b, hq, hkv, s, d, length, int8, window, ring) in SHAPES.items():
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, torch.bfloat16,
                                               int8=int8, lengths=[length] * b)
        for mode in modes:
            if mode == "lut":
                kw["exp_mode"] = "lut"
            times[name if mode == "native" else f"lut {name}"] = timer(
                lambda: ops.swiftkv_decode(q, k, v, lengths, window=window, ring=ring, **kw))
        kw.pop("exp_mode", None)
        if "form" in params and ops.kernel_form(hq // hkv, d, q.dtype, k.dtype) == "mma":
            times[f"fold {name}"] = timer(lambda: ops.launch(
                q, k, v, lengths, window=window, ring=ring, form="fold", **kw))
    return {"ms": times, "outputs_sha256": {f: h.hexdigest() for f, h in digests.items()}}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1], json.loads(argv[2]))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("swiftkv_times: no CUDA device", file=sys.stderr)
        return 1
    forms = labels()
    srcs = argv or [str(ROOT / "src")]
    results = []
    for src in srcs:
        res = subprocess.run([sys.executable, __file__, "--one", str(Path(src).resolve()),
                              json.dumps(forms)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, sep="\n", file=sys.stderr)
            return res.returncode
        got = json.loads(res.stdout.strip().splitlines()[-1])
        results.append({"src": src, **got})
        for name, ms in got["ms"].items():
            print(f"[time] {src}: swiftkv_decode {name}: {ms:.4f} ms", flush=True)
        print(f"[bits] {src}: outputs sha256 by form "
              + ", ".join(f"{f} {h[:16]}" for f, h in sorted(got["outputs_sha256"].items())),
              flush=True)
    for form in sorted(set(forms)):
        n_cases = forms.count(form)
        same = len({r["outputs_sha256"][form] for r in results}) == 1
        print(f"[bits] {form} form ({n_cases} cases x 8 n_split): outputs bitwise equal "
              f"across the {len(srcs)} runs: {same}")
    print(json.dumps(results))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
