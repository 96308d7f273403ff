"""Where ``chip_smoke.py``'s seconds go, leg by leg (GPU).

    python3 tools/chip_smoke_legs.py [--out build/leg_times.txt]

Builds the kernels with each ``nvcc`` unit timed, then runs the script's
five leg phases (no kernel checks, training, timings, dry run, paper or
examples) with the helpers they call wrapped in a timer: the inclusive
seconds of each call path, by the leg that made it (``legD2
_serve_leg>_compare_paths>prefill  62.43 s  8`` reads: leg D2's
comparison spent 62.43 s in 8 prefills). Serving runs, prefills and
decode steps are synchronized before and after, model calls inside a
``decode_multi`` block are not (the sync-debug check forbids it). Run it
on the tree whose legs are to be cut, before cutting them.
"""
from __future__ import annotations

import argparse
import collections
import functools
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# chip_smoke's helpers whose calls are timed, by the name they are called by
HELPERS = ("_serve_leg", "_compare_paths", "_cross_read_check", "_ring_vs_twin",
           "_continuous_leg", "_sync_free_block", "_lockstep_agreement", "_ring_reuse",
           "_counted_run", "_extras_legs", "_tokenwise_leg", "_chunked_vs_lockstep",
           "_moe_drops", "_ep_leg", "_sp_leg", "_init_weights", "_step_breakdown",
           "_pooled_read_check", "_ingest_fault_leg")


class Timings:
    """Inclusive seconds and calls of each (leg, call path). A call's leg is
    the first string argument that names one (``"legD2"``), else its
    caller's."""

    def __init__(self, torch):
        self.torch = torch
        self.secs = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.stack: list[tuple[str, str]] = []

    def wrap(self, name, fn, sync=True):
        @functools.wraps(fn)
        def call(*args, **kw):
            label = self.stack[-1][0] if self.stack else "-"
            label = next((a for a in args[:3] if isinstance(a, str) and a.startswith("leg")),
                         label)
            path = ">".join([n for leg, n in self.stack if leg == label] + [name])
            self.stack.append((label, name))
            if sync:
                self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                if sync:
                    self.torch.cuda.synchronize()
                self.stack.pop()
                self.secs[label, path] += time.perf_counter() - t0
                self.calls[label, path] += 1
        return call

    def lines(self) -> list[str]:
        return [f"{label:12s} {path:72s} {secs:8.2f} s {self.calls[label, path]:5d}"
                for (label, path), secs in sorted(self.secs.items())]


def timed_build(build_mod) -> list[str]:
    """Build every library with each ``nvcc`` wrapped to print its own
    seconds; those lines, then the build's."""
    popen = build_mod.subprocess.Popen

    def popen_timed(cmd, **kw):
        script = ('s=$(date +%s%N); "$@"; rc=$?; echo "[legs] nvcc '
                  '$(( ($(date +%s%N) - s) / 1000000 )) ms: ${@: -1}"; exit $rc')
        return popen(["bash", "-c", script, "_", *cmd], **kw)
    build_mod.subprocess.Popen = popen_timed
    try:
        t0 = time.perf_counter()
        logs = build_mod.build()
    finally:
        build_mod.subprocess.Popen = popen
    return ([ln for text in logs.values() for ln in text.splitlines()
             if ln.startswith("[legs]")] + [f"[legs] build {time.perf_counter() - t0:.1f} s"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "leg_times.txt"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.models import quantized, transformer, whisper
    from repro_torch.serving import continuous, engine
    resolve_device()
    t_start = time.perf_counter()
    timings = Timings(torch)
    for name in HELPERS:
        setattr(cs, name, timings.wrap(name, getattr(cs, name)))
    quantized.quantize_params = timings.wrap("quantize_params", quantized.quantize_params)
    for cls in (transformer.TransformerLM, whisper.WhisperModel):
        for m in ("prefill", "decode_step", "prefill_chunk", "decode_multi"):
            setattr(cls, m, timings.wrap(m, getattr(cls, m), sync=False))
    engine.ServingEngine.generate = timings.wrap("generate", engine.ServingEngine.generate)
    for m in ("run", "warmup"):
        setattr(continuous.ContinuousBatchingEngine, m,
                timings.wrap(m, getattr(continuous.ContinuousBatchingEngine, m)))
    cs._CallCheck.__call__ = timings.wrap("callcheck", cs._CallCheck.__call__, sync=False)

    dev = cs.phase_device(torch)
    lines = timed_build(_build)
    for line in lines:
        print(line, flush=True)
    for phase in (cs.phase_legs, cs.phase_ring_legs, cs.phase_family_legs,
                  cs.phase_recurrent_legs, cs.phase_xattn_legs):
        t0 = time.perf_counter()
        phase(torch, dev, False)
        torch.cuda.empty_cache()
        lines.append(f"[legs] {phase.__name__} done in {time.perf_counter() - t0:.1f} s")
        print(lines[-1], flush=True)
    lines += timings.lines() + [f"[legs] all in {time.perf_counter() - t_start:.1f} s"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print("\n".join(lines[-len(timings.secs) - 1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
