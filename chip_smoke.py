#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--breakdown]

Needs one NVIDIA GPU (Hopper, sm_90a) and the CUDA toolkit's nvcc. It:

1. prints the card (name and power limit as nvidia-smi gives them) and the
   torch / CUDA / nvcc versions;
2. builds both hand-written kernels from ``src/repro_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at edge cases, and the reduced models on the
   card against the same models on the CPU; ``swiftkv_decode`` also at
   every split of S over CTAs (n_split 1, 2, 3, 8 and its own choice)
   against the plain model of that split, and for bitwise-equal repeats
   and CUDA-graph replay; the decode form of ``gemv_w4a8`` (M <= 8) at
   every M 1-8, K and N of the path and edge shapes, f32 and bf16 x, every
   cluster size and tile width, against the plain version and the plain
   model of its split of K, its row scales bitwise equal to
   ``quantize_a8``'s, rows on the quantizer's edges, repeats and replay;
4. leg A: serves llama2-7b at its published width (all 32 layers, bf16,
   random weights from a seed) through ``ServingEngine`` with
   ``decode_impl="kernel"`` — batch 8, prompt 512, 64 greedy steps — and
   checks that every decode attention went through the CUDA kernel;
5. leg B: the same for ``llama2-7b+w4a8`` (weights quantized on the card,
   int8 KV cache) — batch 8, prompt 128, 64 steps — checking the launch
   counts: one decode-form GEMV per decode-step projection, the other form
   for the prefill, no split-K reduce, int8 attention;
   after each leg, a prefill and a decode step of the kernel path are held
   against the plain path, and in float32 every kernel call of them against
   its plain version on the same inputs; ``--breakdown`` also splits the
   decode step's time (eager, CUDA-graph replay, profiler kernel time) and
   counts its device kernels;
6. times each kernel, its plain version and a PyTorch library call at the
   serving path's shapes (CUDA events around CUDA-graph replays, median of
   25, L2 flushed before each), beside the least time the card could take;
   ``swiftkv_decode`` also at every n_split, with a read flush of the L2,
   and beside the timer's own floor and a plain read of the same bytes;
   the decode form of ``gemv_w4a8`` also with a read flush and at every
   tile width and cluster size.

``--breakdown-only`` builds the kernels and runs only the decode-step
breakdowns, with no check: it uses nothing but the model API, so it also
runs from an older tree of the port, for a before/after on one card.

It prints one line per phase, then a JSON line with every kernel's numbers,
the card line, and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a GPU it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets) by card: memory bytes/s,
# bf16 FLOP/s and int8 OP/s of the tensor cores.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 1513e12),
    "H100 NVL": (3.9e12, 835e12, 1671e12),
    "H200": (4.8e12, 989e12, 1979e12),
    "H100": (3.35e12, 989e12, 1979e12),       # SXM
}


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple[float, float, float]:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    log(f"[device] {name} not in the peak table: bounds use the H100 SXM's")
    return PEAKS["H100"]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of ``fn()``: the call is captured once into a CUDA graph
    (so host overhead is excluded) and replayed ``runs`` times between CUDA
    events, with the L2 cache flushed before each replay; returns the
    median in ms. The flush writes 256 MB (``flush="write"``, the default,
    which leaves ~50 MB of dirty lines that the timed call must write back
    as it evicts them) or reads them (``"read"``: clean lines)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, runs: int = 25, flush: str = "write") -> float:
        torch = self.torch
        fn()                                   # load libraries, set attributes
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        times = []
        for _ in range(runs):
            if flush == "write":
                self.flush.zero_()
            else:
                self.flush.max()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([_build().nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[device] {card_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc} | "
        f"python {sys.version.split()[0]}")
    mem_bps, bf16_ops, int8_ops = peaks_for(name)
    return {"name": name, "mem_bps": mem_bps, "bf16_ops": bf16_ops, "int8_ops": int8_ops}


def _build():
    from repro_torch.kernels import _build as build_mod
    return build_mod


def phase_build() -> None:
    build_mod = _build()
    t0 = time.perf_counter()
    logs = build_mod.build()
    log(f"[build] {len(logs)} kernel libraries built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(build_mod.KERNELS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
                log(f"[build] {name}: {line.strip()}")


def _rand(torch, gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, dtype, *, int8=False, lengths=None,
                    scale_dtype=None):
    from repro_torch.core.quantization import quantize_kv
    scale_dtype = scale_dtype or torch.bfloat16
    q = _rand(torch, gen, b, hq, d, dtype=dtype)
    k = _rand(torch, gen, b, s, hkv, d, dtype=dtype)
    v = _rand(torch, gen, b, s, hkv, d, dtype=dtype)
    if lengths is None:
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        lengths[0], lengths[-1] = 1, s           # ragged, with both extremes
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    kw = {}
    if int8:
        k, ks = quantize_kv(k)                   # scales [B, S, Hkv] -> [B, Hkv, S]
        v, vs = quantize_kv(v)
        kw = {"k_scale": ks.transpose(1, 2).contiguous().to(scale_dtype),
              "v_scale": vs.transpose(1, 2).contiguous().to(scale_dtype)}
    return q, k, v, lengths, kw


def phase_kernel_checks(torch) -> None:
    from repro_torch.core.quantization import quantize_w4
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    # Tolerances. Kernel and plain version both compute in f32 and round the
    # output once, in another summation order: a bf16 output may differ by
    # about one bf16 step (2^-8 relative at |out| ~ 1), f32 by f32 rounding
    # (~1e-7 of |out|). The f32 cases at the path's shapes (several 64-row
    # tiles, ragged lengths) are the tight ones: long rows give outputs of
    # ~0.05, and a window off by one position or a missed rescale of one
    # tile moves them by ~1e-3, far above 1e-5.
    cases = [  # name, B, Hq, Hkv, S, D, dtype, window, int8, atol
        ("llama2 bf16", 8, 32, 32, 1024, 128, torch.bfloat16, None, False, 1e-2),
        ("qwen3 GQA 32/8 bf16", 8, 32, 8, 1024, 128, torch.bfloat16, None, False, 1e-2),
        ("llama2 int8+bf16 scales", 8, 32, 32, 1024, 128, torch.bfloat16, None, True, 1e-2),
        ("llama2 window 256", 8, 32, 32, 1024, 128, torch.bfloat16, 256, False, 1e-2),
        ("llama2 f32", 8, 32, 32, 1024, 128, torch.float32, None, False, 1e-5),
        ("llama2 f32 window 256", 8, 32, 32, 1024, 128, torch.float32, 256, False, 1e-5),
        ("llama2 f32 int8+bf16 scales", 8, 32, 32, 640, 128, torch.float32, None, True, 1e-5),
        ("llama2 f32 int8 window 256", 8, 32, 32, 640, 128, torch.float32, 256, True, 1e-5),
        ("qwen3 GQA 32/8 f32", 8, 32, 8, 640, 128, torch.float32, None, False, 1e-5),
        ("reduced D=16 f32", 2, 4, 2, 64, 16, torch.float32, None, False, 1e-5),
        ("reduced D=16 f32 int8", 2, 4, 2, 64, 16, torch.float32, None, True, 1e-5),
    ]
    for name, b, hq, hkv, s, d, dt, win, int8, atol in cases:
        q, k, v, lens, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, dt, int8=int8)
        got = skv_ops.swiftkv_decode(q, k, v, lens, window=win, **kw)
        torch.cuda.synchronize()
        want = skv_ref.swiftkv_decode_ref(q, k, v, lens, window=win, **kw)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.isfinite(got).all().item() and err <= atol
        log(f"[check] swiftkv_decode {name}: max_abs_err {err:.3g} (atol {atol:g})")
        if not ok:
            raise AssertionError(f"swiftkv_decode {name}: err {err} > {atol}")
    # a row of length 0 attends nothing and must give an exact 0
    q, k, v, lens, kw = _swiftkv_inputs(torch, gen, 2, 4, 2, 64, 16, torch.float32,
                                        lengths=[0, 64])
    got = skv_ops.swiftkv_decode(q, k, v, lens)
    torch.cuda.synchronize()
    if not (got[0] == 0).all().item():
        raise AssertionError("swiftkv_decode: a length-0 row is not exactly 0")
    log("[check] swiftkv_decode length-0 row: exact 0")
    _check_swiftkv_split(torch, gen)

    # The integer group sums are exact on both sides; only the f32 sum over
    # groups differs in order: relative error ~ K/128 f32 roundings.
    for m in (1, 8, 1024):
        for k_dim, n in ((4096, 4096), (4096, 11008), (11008, 4096), (64, 96)):
            if k_dim == 64 and m == 1024:
                continue
            x = _rand(torch, gen, m, k_dim, dtype=torch.bfloat16)
            qw = quantize_w4(_rand(torch, gen, k_dim, n, dtype=torch.float32) * 0.02)
            got = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
            torch.cuda.synchronize()
            want = gemv_ref.gemv_w4a8_ref(x, qw.packed, qw.scale)
            err = (got - want).abs().max().item()
            tol = 1e-5 * want.abs().max().item() + 1e-6
            log(f"[check] gemv_w4a8 M={m} K={k_dim} N={n}: max_abs_err {err:.3g} "
                f"(tol {tol:.3g})")
            if not (torch.isfinite(got).all().item() and err <= tol):
                raise AssertionError(f"gemv_w4a8 M={m} K={k_dim} N={n}: err {err} > {tol}")
    _check_gemv_decode(torch, gen)


def _gemv_err(torch, got, *wants):
    """Max |got - want| over ``wants``, and the tolerance: 1e-5 of max
    |want| (+1e-6). Integer group sums are exact on every side; only the
    f32 sum over groups differs in order, ~K/128 f32 roundings."""
    err = max((got - w).abs().max().item() for w in wants)
    return err, 1e-5 * max(w.abs().max().item() for w in wants) + 1e-6


def _check_gemv_decode(torch, gen) -> None:
    """The decode form (M <= 8, quantization inside, split-K in a cluster),
    where it can go wrong: every M 1-8 at each K (one group, a ragged
    second group, the path's 4096 and 11008) and N (96 and qwen3-8b's 1024
    besides the path's), x in f32 and bf16, against the plain version and
    the plain model of its split; its row scales bitwise equal to
    quantize_a8's; every cluster size and tile width; rows built on the
    quantizer's edges; bitwise repeats and CUDA-graph replay."""
    from repro_torch.core.quantization import quantize_a8, quantize_w4
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    f32, bf16 = torch.float32, torch.bfloat16

    def run(x, qw, tile_bytes=None, ks=None):
        """Kernel output, its row scales, the plain version and the split
        model at the kernel's ks."""
        m, k = x.shape
        plan = gemv_ops.decode_plan(m, k, qw.packed.shape[1] * 2, sm_count)
        ks = ks or plan[1]
        scales = torch.full((m,), float("nan"), device="cuda")
        got = gemv_ops.launch_decode(x, qw.packed, qw.scale, tile_bytes=tile_bytes, ks=ks,
                                     scales_out=scales)
        torch.cuda.synchronize()
        want = gemv_ref.gemv_w4a8_ref(x, qw.packed, qw.scale)
        model = gemv_ref.gemv_w4a8_split_ref(x, qw.packed, qw.scale, ks=ks)
        same_scales = torch.equal(scales, quantize_a8(x)[1][:, 0])
        return got, want, model, same_scales

    def weights(k_dim, n):
        return quantize_w4(_rand(torch, gen, k_dim, n, dtype=f32) * 0.02)

    for k_dim in (64, 200, 4096, 11008):
        for n in (96, 1024, 4096, 11008):
            qw = weights(k_dim, n)
            plan = gemv_ops.decode_plan(8, k_dim, n, sm_count)
            worst = 0.0
            for dt in (f32, bf16):
                for m in range(1, 9):
                    x = _rand(torch, gen, m, k_dim, dtype=dt)
                    got = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)     # the wrapper's path
                    _, want, model, same_scales = run(x, qw)
                    err, tol = _gemv_err(torch, got, want, model)
                    worst = max(worst, err / tol)
                    if not (torch.isfinite(got).all().item() and err <= tol and same_scales):
                        raise AssertionError(
                            f"gemv_w4a8 decode M={m} K={k_dim} N={n} {dt}: err {err} > {tol} "
                            f"or row scales differ from quantize_a8's ({same_scales})")
            log(f"[check] gemv_w4a8 decode K={k_dim} N={n} (tile {plan[0]} B, ks {plan[1]}): "
                f"M 1-8 x f32/bf16 within {worst:.3g} of the tolerance (1e-5 of max |out|) "
                f"of the plain version and the split model; row scales bitwise equal")

    for k_dim, n, m, dt in ((11008, 1024, 8, bf16), (4096, 4096, 5, f32), (1000, 96, 3, f32),
                            (200, 11008, 8, bf16)):
        qw = weights(k_dim, n)
        x = _rand(torch, gen, m, k_dim, dtype=dt)
        errs = []
        for ks in range(1, min(gemv_ops.MAX_RANKS, -(-k_dim // 128)) + 1):
            for tile_bytes in gemv_ops.TILE_BYTES:
                got, want, model, same_scales = run(x, qw, tile_bytes, ks)
                err, tol = _gemv_err(torch, got, want, model)
                errs.append(err / tol)
                if not (err <= tol and same_scales):
                    raise AssertionError(f"gemv_w4a8 decode K={k_dim} N={n} M={m} ks={ks} "
                                         f"tile {tile_bytes}: err {err} > {tol}")
        log(f"[check] gemv_w4a8 decode K={k_dim} N={n} M={m} {dt}: every ks 1-{ks} x tile "
            f"{gemv_ops.TILE_BYTES} B within {max(errs):.3g} of the tolerance")

    # rows on the quantizer's edges: half-even ties at scale 1 (amax 127,
    # values +-2.5, 0.5, 1.5), an all-zero row (scale 1, output exactly 0),
    # a row whose amax / 127 is not a bf16 value, and one whose float
    # reciprocal product and quotient differ
    import numpy as np
    amax = np.float32(3.0)
    cands = np.linspace(1, 2, 4001, dtype=np.float32)
    recip = cands * (np.float32(1) / np.float32(127)) != cands / np.float32(127)
    amax_recip = cands[recip][0]
    for dt in (f32, bf16):
        k_dim, n = 4096, 4096
        qw = weights(k_dim, n)
        x = _rand(torch, gen, 8, k_dim, dtype=f32)
        x[0] = 0
        x[0, :7] = torch.tensor([127.0, 2.5, -2.5, 0.5, -0.5, 1.5, -1.5])
        x[0, 1000:1003] = torch.tensor([2.5, -3.5, 126.5])
        x[1] = 0
        x[2] = x[2] / x[2].abs().max() * float(amax)
        x[3] = x[3] / x[3].abs().max() * float(amax_recip)
        x = x.to(dt)
        got, want, model, same_scales = run(x, qw)
        err, tol = _gemv_err(torch, got, want, model)
        codes = quantize_a8(x)[0][0, [1, 2, 3, 4, 5, 6, 1000, 1001, 1002]].tolist()
        log(f"[check] gemv_w4a8 decode quantizer edge rows {dt}: max_abs_err {err:.3g} "
            f"(tol {tol:.3g}), row scales bitwise equal {same_scales}, zero row exactly 0 "
            f"{(got[1] == 0).all().item()}; plain codes of the ties {codes}")
        if not (err <= tol and same_scales and (got[1] == 0).all().item()):
            raise AssertionError(f"gemv_w4a8 decode quantizer edge rows ({dt}) differ")

    qw = weights(4096, 11008)
    x = _rand(torch, gen, 8, 4096, dtype=bf16)
    first = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
    second = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
    graph.replay()
    torch.cuda.synchronize()
    log(f"[check] gemv_w4a8 decode M=8 K=4096 N=11008: two launches bitwise equal "
        f"{torch.equal(first, second)}, CUDA-graph replay equal to the eager launch "
        f"{torch.equal(captured, first)}")
    if not (torch.equal(first, second) and torch.equal(captured, first)):
        raise AssertionError("gemv_w4a8 decode: launches on the same inputs differ")
    del graph


def _check_swiftkv_split(torch, gen) -> None:
    """The split of S over CTAs, where it can go wrong: each case at
    n_split 1, 2, 3, 8 and the wrapper's own choice, against the plain
    version and against the plain model of the split at the same n_split
    (``swiftkv_decode_split_ref``); ragged lengths leave whole chunks
    empty, windows put lo inside a tile, rows of length 0 must be an exact
    0. Then at leg A's shape: two launches bitwise equal, and one launch
    captured in a CUDA graph and replayed equal to the eager launch."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    f32, bf16 = torch.float32, torch.bfloat16
    t = skv_ops.TILE
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    ragged = [0, 1, t - 1, t, 256]
    # name, B, Hq, Hkv, S, D, dtype, window, int8 scale dtype (or None), lengths, atol
    cases = [
        ("ragged G=4 f32", 5, 8, 2, 256, 128, f32, None, None, ragged, 1e-5),
        ("ragged G=1 bf16", 5, 4, 4, 256, 128, bf16, None, None, ragged, 1e-2),
        ("window 100 (lo inside a tile) f32", 4, 8, 8, 256, 128, f32, 100, None,
         [256, 200, 77, 1], 1e-5),
        ("int8+bf16 scales ragged f32", 5, 8, 2, 256, 128, f32, None, bf16, ragged, 1e-5),
        ("int8 window 50 f32", 4, 8, 8, 256, 128, f32, 50, bf16, [256, 131, 30, 0], 1e-5),
        ("G=8 f32", 4, 64, 8, 256, 128, f32, None, None, [1, 100, 255, 256], 1e-5),
        ("G=8 bf16", 4, 64, 8, 256, 128, bf16, None, None, [1, 100, 255, 256], 1e-2),
        ("G=8 D=256 f32", 2, 16, 2, 128, 256, f32, None, None, [128, 70], 1e-5),
        ("G=3 D=96 f32", 3, 6, 2, 160, 96, f32, 60, None, [0, 97, 160], 1e-5),
        ("int8+f32 scales D=24 (8-byte copies) f32", 3, 4, 2, 96, 24, f32, 40, f32,
         [0, 50, 96], 1e-5),
        ("int8 S=100 (scales read in place) f32", 3, 4, 2, 100, 32, f32, None, bf16,
         [0, 99, 100], 1e-5),
    ]
    for name, b, hq, hkv, s, d, dt, win, sc_dt, lens, atol in cases:
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, dt,
                                               int8=sc_dt is not None, lengths=lens,
                                               scale_dtype=sc_dt)
        want = skv_ref.swiftkv_decode_ref(q, k, v, lengths, window=win, **kw).float()
        errs = []
        for n_split in (1, 2, 3, 8, None):
            ns = n_split or skv_ops.split_count(b, hkv, s, sm_count)
            out = skv_ops.launch(q, k, v, lengths, window=win, n_split=n_split, **kw)
            torch.cuda.synchronize()
            model = skv_ref.swiftkv_decode_split_ref(q, k, v, lengths, n_split=ns,
                                                     window=win, **kw).float()
            err = max((out.float() - want).abs().max().item(),
                      (out.float() - model).abs().max().item())
            errs.append(f"{ns}{'' if n_split else ' (own)'}: {err:.3g}")
            zero_rows = [i for i, n in enumerate(lens) if n == 0]
            if not (torch.isfinite(out).all().item() and err <= atol
                    and all((out[i] == 0).all().item() for i in zero_rows)):
                raise AssertionError(f"swiftkv_decode split {name} n_split={ns}: err {err} "
                                     f"> {atol} or a length-0 row not exactly 0")
        log(f"[check] swiftkv_decode split {name}: max_abs_err vs plain and vs split model "
            f"by n_split {{{', '.join(errs)}}} (atol {atol:g}; length-0 rows exact 0)")

    for name, hkv in (("leg A", 32), ("GQA 32/8", 8)):
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, 8, 32, hkv, 640, 128, bf16,
                                               lengths=[576] * 6 + [1, 0])
        run = lambda: skv_ops.swiftkv_decode(q, k, v, lengths)
        first, second = run(), run()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = run()
        graph.replay()
        torch.cuda.synchronize()
        n_split = skv_ops.split_count(8, hkv, 640, sm_count)
        same = torch.equal(first, second) and torch.equal(captured, first)
        log(f"[check] swiftkv_decode {name} shape (n_split {n_split}): two launches bitwise "
            f"equal {torch.equal(first, second)}, CUDA-graph replay equal to the eager "
            f"launch {torch.equal(captured, first)}")
        if not same or not (first[-1] == 0).all().item():
            raise AssertionError(f"swiftkv_decode {name}: launches on the same inputs "
                                 f"differ, or a length-0 row is not exactly 0")
        del graph


def phase_reduced_models(torch) -> None:
    """Reduced models on the card (kernels, f32) against the same models on
    the CPU (plain versions): same weights, greedy tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import ServingEngine
    for arch in ("llama2-7b", "qwen3-8b+w4a8"):
        cfg = get_config(arch, reduced=True).replace(decode_impl="kernel")
        cpu = build_model(cfg, device="cpu")
        params = cpu.init_params(0)
        gpu = build_model(cfg, device="cuda")
        params_gpu = _tree_to(params, "cuda")
        prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                                generator=torch.Generator().manual_seed(3))
        want = ServingEngine(cpu, params, max_len=64, batch=4).generate(prompts, steps=16)
        got = ServingEngine(gpu, params_gpu, max_len=64, batch=4).generate(prompts, steps=16)
        same = (got.cpu() == want).float().mean().item()
        log(f"[check] reduced {arch}: card vs CPU greedy token agreement {same:.4f}")
        if same != 1.0:
            raise AssertionError(f"reduced {arch}: card tokens differ from the CPU's")


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _serve_leg(torch, label, model, params, *, prompt_len, steps, expect, plain_model,
               rel_tols, mem_bps, breakdown):
    """Drive ``ServingEngine.generate`` (the main path) once with the launch
    counts zeroed, then compare a prefill and a decode step with the plain
    path on the same weights and cache. ``rel_tols`` maps each dtype to the
    limit of that comparison (see ``_compare_paths``)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine
    cfg = model.cfg
    batch = 8
    eng = ServingEngine(model, params, max_len=prompt_len + steps, batch=batch)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    eng.generate(prompts, steps=2)                              # warmup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, steps=0).cpu()                        # prefill + first pick
    prefill_s = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=steps).cpu()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    decode_ms = 1e3 * (wall - prefill_s) / steps
    log(f"[{label}] {cfg.name}: batch {batch}, prompt {prompt_len}, {steps} greedy steps; "
        f"prefill {1e3 * prefill_s:.1f} ms, decode {decode_ms:.2f} ms/step "
        f"({batch * 1e3 / decode_ms:.1f} tokens/s), end to end "
        f"{batch * steps / wall:.1f} tokens/s over {wall:.2f} s")
    log(f"[{label}] launches on the serving path: {counts}")
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != expected {expect}")
    if out.shape != (batch, steps) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{label}: bad output tokens {out.shape}")

    _compare_paths(torch, label, model, plain_model, eng.params, prompts, prompt_len + steps,
                   rel_tols)
    if breakdown:
        _step_breakdown(torch, label, model, eng.params, prompts, prompt_len + steps, mem_bps)
    return {"prefill_ms": 1e3 * prefill_s, "decode_ms_per_step": decode_ms,
            "tokens_per_s": batch * steps / wall, "launches": counts}


def _step_bytes(params, cache, batch: int) -> tuple[int, int]:
    """Bytes one decode step must read: every weight once (the embedding
    only at the batch's rows) and the KV cache up to each row's length."""
    weights = sum(t.numel() * t.element_size() for k, t in _items(params) if k != "embed")
    weights += batch * params["embed"].shape[1] * params["embed"].element_size()
    length = int(cache["len"].max()) + 1
    kv = 0
    for key, pos_axis in (("k", 2), ("v", 2), ("k_scale", 3), ("v_scale", 3)):
        if key in cache:            # [L, B, S, Hkv, Dh] rows, [L, B, Hkv, S] scales
            t = cache[key]
            kv += t.numel() * t.element_size() * length // t.shape[pos_axis]
    return weights, kv


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _step_breakdown(torch, label, model, params, prompts, max_len, mem_bps, n_steps=8):
    """Where one decode step's time goes, after a prefill (``--breakdown``
    only): the eager step (host clock, synchronized), the same step
    replayed from a CUDA graph (device work with no host gaps), and the
    profiler's device time by kernel over eager steps."""
    from torch.profiler import ProfilerActivity, profile
    batch = prompts.shape[0]
    with torch.inference_mode():
        cache = model.init_cache(batch, max_len)
        logits, cache = model.prefill(params, prompts, cache)
        tok = logits.argmax(-1).to(torch.int32)
        model.decode_step(params, tok, cache)
        w_bytes, kv_bytes = _step_bytes(params, cache, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t0) / n_steps

        # the CPU activity is what attributes launches to kernels; only the
        # device-side (kernel) events are summed, or each op counts twice
        prof_steps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(prof_steps):
                model.decode_step(params, tok, cache)
            torch.cuda.synchronize()
        by_kernel, per_step = {}, {}
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            if dev_us > 0:
                by_kernel[ev.key] = dev_us / 1e3 / prof_steps
                per_step[ev.key] = ev.count / prof_steps
        busy_ms = sum(by_kernel.values())

        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            model.decode_step(params, tok, cache)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n_steps):
            graph.replay()
        end.record()
        end.synchronize()
        graph_ms = start.elapsed_time(end) / n_steps
        del graph, cache
    log(f"[{label}] decode step at length ~{prompts.shape[1]}: eager {eager_ms:.2f} ms, "
        f"CUDA-graph replay {graph_ms:.2f} ms, profiler kernel time "
        + (f"{busy_ms:.2f} ms/step (device idle share of the eager step "
           f"{1 - busy_ms / eager_ms:.2f})" if busy_ms else "not measured"))
    bound_ms = 1e3 * (w_bytes + kv_bytes) / mem_bps
    log(f"[{label}] decode-step bound: weights {w_bytes / 1e9:.3f} GB + KV cache "
        f"{kv_bytes / 1e9:.3f} GB -> {bound_ms:.3f} ms at {mem_bps / 1e12:.2f} TB/s")
    log(f"[{label}] device kernels per decode step (profiler, every device op counted): "
        f"{sum(per_step.values()):.0f}, {len(per_step)} distinct; by device time:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        log(f"[{label}]   {ms:8.3f} ms/step {per_step[name]:5.0f}x  {name[:90]}")


@contextlib.contextmanager
def _swapped(module, name, fn):
    """``module.name`` is ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


class _CallCheck:
    """While entered, every call of the kernel wrapper ``module.name`` also
    runs ``plain`` on the same inputs; ``worst`` keeps the largest max
    |difference| as a fraction of the plain output's max |value|."""

    def __init__(self, module, name, plain):
        self.module, self.name, self.plain = module, name, plain
        self.calls, self.worst = 0, 0.0

    def __enter__(self):
        self.kernel = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.kernel)

    def __call__(self, *args, **kw):
        got = self.kernel(*args, **kw)
        want = self.plain(*args, **kw).float()
        err = (got.float() - want).abs().max().item()
        self.worst = max(self.worst, err / max(want.abs().max().item(), 1e-30))
        self.calls += 1
        return got


NOISE = 2.0 ** -23      # relative GEMV noise of the witness runs (~1e-7)
PER_CALL_TOL = 1e-5     # f32 kernel call vs plain version, of max |output|


def _noisy(torch, plain, gen):
    """``plain`` GEMV with each output multiplied by (1 + NOISE * N(0, 1))."""
    def call(x, packed, w_scale):
        out = plain(x, packed, w_scale)
        return out * (1 + NOISE * torch.randn(out.shape, generator=gen, device=out.device))
    return call


def _compare_paths(torch, label, model, plain_model, params, prompts, max_len, rel_tols):
    """Kernel path vs plain path on the same weights and cache state: the
    prefill logits and one decode step's, in the serving dtype (bf16) and
    with the whole model computing in float32.

    The plain path is ``plain_model`` (plain decode attention) with the GEMV
    wrapper swapped for its plain version, here and nowhere else. In the
    float32 run every kernel call of the kernel path is also held against
    its plain version on the same inputs, to PER_CALL_TOL.

    ``rel_tols`` maps each dtype to the limit on max |logit difference| as
    a fraction of max |logit|, or to None. None takes the limit from this
    run's witness: the plain path against itself with every GEMV output
    moved by NOISE, about what another f32 summation order moves it, with
    two seeds. The limit is twice the larger witness spread: the spread the
    W4A8 path shows by itself once such a move flips int8 activation codes
    (on an H100 the kernel path's difference came to 0.9-1.0 times it)."""
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    from repro_torch.models.api import build_model
    batch = prompts.shape[0]
    for dtype, rel_tol in rel_tols.items():
        kern, plain = model, plain_model
        if dtype != model.cfg.compute_dtype:
            kern = build_model(model.cfg.replace(compute_dtype=dtype), device=model.device)
            plain = build_model(plain_model.cfg.replace(compute_dtype=dtype),
                                device=model.device)
        checks = []
        if dtype == "float32":
            checks = [_CallCheck(gemv_ops, "gemv_w4a8", gemv_ref.gemv_w4a8_ref),
                      _CallCheck(skv_ops, "swiftkv_decode", skv_ref.swiftkv_decode_ref)]
        with torch.inference_mode(), contextlib.ExitStack() as stack:
            for check in checks:
                stack.enter_context(check)
            cache = kern.init_cache(batch, max_len)
            logits_k, cache = kern.prefill(params, prompts, cache)
            tok = logits_k.argmax(-1).to(torch.int32)
            snapshot = {k: v.clone() for k, v in cache.items()}
            step_k, _ = kern.decode_step(params, tok, cache)
        del cache
        for check in (c for c in checks if c.calls):
            log(f"[{label}] every {check.name} call of a float32 prefill + decode step "
                f"against its plain version on the same inputs: {check.calls} calls, "
                f"worst max_abs_err {check.worst:.3g} of max |out| (tol {PER_CALL_TOL:g})")
            if check.worst > PER_CALL_TOL:
                raise AssertionError(f"{label}: a {check.name} call is off its plain "
                                     f"version by {check.worst:.3g} of its output")

        def plain_run(gemv):
            with torch.inference_mode(), _swapped(gemv_ops, "gemv_w4a8", gemv):
                logits, _ = plain.prefill(params, prompts, plain.init_cache(batch, max_len))
                step, _ = plain.decode_step(params, tok,
                                            {k: v.clone() for k, v in snapshot.items()})
            return logits, step

        plain_out = plain_run(gemv_ref.gemv_w4a8_ref)
        witness = []
        if rel_tol is None:
            for seed in (0, 1):
                gen = torch.Generator(device=prompts.device).manual_seed(seed)
                witness.append(plain_run(_noisy(torch, gemv_ref.gemv_w4a8_ref, gen)))
        del snapshot
        for i, (what, a) in enumerate((("prefill", logits_k), ("decode step", step_k))):
            b = plain_out[i]
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            if rel_tol is None:
                spread = max((w[i] - b).abs().max().item() for w in witness)
                w_agree = min((w[i].argmax(-1) == b.argmax(-1)).float().mean().item()
                              for w in witness)
                limit = max(2 * spread, 1e-5 * scale)
                how = (f"limit 2 x the witness spread {spread:.4g} (plain path with "
                       f"GEMV outputs moved by {NOISE:.3g}; its argmax agreement "
                       f"{w_agree:.3f})")
            else:
                limit = rel_tol * scale
                how = f"tol {rel_tol:g} x"
            log(f"[{label}] {what} logits in {dtype}, kernel vs plain path: max_abs_err "
                f"{err:.4g} of max |logit| {scale:.4g}, argmax agreement {agree:.3f}; {how}")
            if not (torch.isfinite(a).all().item() and err <= limit):
                raise AssertionError(f"{label} {what} ({dtype}): kernel path off the "
                                     f"plain path by {err} > {limit}")


def _reduce_launches(torch, cfg, batch, prompt_len) -> int:
    """Split-K reduce launches of the GEMV wrapper over a ``generate`` run:
    only the prefill's projections (M = batch x prompt > 8) take the form
    that splits K across launches; the decode form merges in a cluster."""
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.resolved_head_dim, cfg.n_kv_heads * cfg.resolved_head_dim
    shapes = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, f), (d, f), (f, d)]
    return cfg.n_layers * sum(gemv_ops.split_k(batch * prompt_len, k, n, sm) > 1
                              for k, n in shapes)


def _breakdown_only(torch, label, model, params, prompt_len, steps, mem_bps) -> None:
    """``--breakdown-only``: the decode-step breakdown of a leg with no
    serving run and no check (it uses only the model API, so it also runs
    on an older tree of the port for a before/after on one card)."""
    prompts = torch.randint(0, model.cfg.vocab_size, (8, prompt_len), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    _step_breakdown(torch, label, model, params, prompts, prompt_len + steps, mem_bps)


def phase_legs(torch, dev: dict, breakdown: bool, breakdown_only: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.quantized import quantize_params
    cfg = get_config("llama2-7b").replace(decode_impl="kernel")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _items(params))
    log(f"[legA] {cfg.name}: {n_params / 1e9:.2f} B random bf16 parameters on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    n_layers, steps = cfg.n_layers, 64
    if breakdown_only:
        _breakdown_only(torch, "legA", model, params, 512, steps, dev["mem_bps"])
        cfg_q = get_config("llama2-7b+w4a8").replace(decode_impl="kernel")
        params_q = quantize_params(params)
        del params
        _breakdown_only(torch, "legB", build_model(cfg_q), params_q, 128, steps,
                        dev["mem_bps"])
        return {}
    leg_a = _serve_leg(
        torch, "legA", model, params, prompt_len=512, steps=steps,
        expect={"swiftkv_decode": n_layers * steps, "swiftkv_decode_int8": 0,
                "gemv_w4a8_decode": 0, "gemv_w4a8": 0, "gemv_w4a8_reduce": 0},
        plain_model=build_model(cfg.replace(decode_impl="blockwise")),
        # float32: the paths differ only in summation order, ~1e-7 per call.
        # bf16: the residual stream is rounded at points one ulp of
        # difference can move, and such flips compound over 32 layers.
        rel_tols={"bfloat16": 0.10, "float32": 1e-3}, mem_bps=dev["mem_bps"],
        breakdown=breakdown)

    cfg_q = get_config("llama2-7b+w4a8").replace(decode_impl="kernel")
    t0 = time.perf_counter()
    params_q = quantize_params(params)
    torch.cuda.synchronize()
    log(f"[legB] quantize_params on the card: {time.perf_counter() - t0:.1f} s")
    del params
    leg_b = _serve_leg(
        torch, "legB", build_model(cfg_q), params_q, prompt_len=128, steps=steps,
        # every decode-step projection is one decode-form launch (M = 8);
        # the prefill's (M = 1024) take the other form
        expect={"swiftkv_decode": 0, "swiftkv_decode_int8": n_layers * steps,
                "gemv_w4a8_decode": 7 * n_layers * steps, "gemv_w4a8": 7 * n_layers,
                "gemv_w4a8_reduce": _reduce_launches(torch, cfg_q, 8, 128)},
        plain_model=build_model(cfg_q.replace(decode_impl="blockwise")),
        # in either dtype a ~1e-7 difference of a GEMV output can move an
        # int8 activation code, and moved codes compound over 32 layers:
        # the limit comes from the witness runs (see _compare_paths)
        rel_tols={"bfloat16": None, "float32": None}, mem_bps=dev["mem_bps"],
        breakdown=breakdown)
    return {"legA": leg_a, "legB": leg_b}


def phase_timings(torch, dev: dict, legs: dict) -> list[dict]:
    """Kernel, plain version and library call at the serving path's shapes,
    beside the bound: max(bytes moved / memory rate, operations / peak)."""
    import torch.nn.functional as F
    from repro_torch.core.quantization import GROUP, quantize_w4, unpack_w4
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count

    def bound(nbytes, ops, peak_ops):
        t_bytes, t_ops = nbytes / dev["mem_bps"], ops / peak_ops
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def calibrate(nbytes):
        """What the timer itself costs, and how fast a plain read of the
        same bytes runs (torch.sum over a flat bf16 buffer)."""
        one = torch.zeros(1, device="cuda")
        buf = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
        log(f"[time]   timer floor (one 1-element op): {timer(lambda: one.add_(1)):.4f} ms; "
            f"torch.sum over the same {nbytes / 1e6:.1f} MB: "
            f"{timer(lambda: buf.sum(dtype=torch.float32)):.4f} ms "
            f"({timer(lambda: buf.sum(dtype=torch.float32), flush='read'):.4f} ms "
            f"with a read flush)")
        del buf

    def swiftkv(b, hq, hkv, s, d, length, int8):
        q, k, v, lens, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, torch.bfloat16,
                                            int8=int8, lengths=[length] * b)
        kern = lambda: skv_ops.swiftkv_decode(q, k, v, lens, **kw)
        plain = lambda: skv_ref.swiftkv_decode_ref(q, k, v, lens, **kw)
        err = (kern().float() - plain().float()).abs().max().item()
        ms, plain_ms = timer(kern), timer(plain)
        library_ms, library_form = None, None
        if not int8:     # one library call computes the same function
            g = hq // hkv
            mask = (torch.arange(s, device="cuda")[None] < lens[:, None])[:, None, None, :]
            kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))   # [B, Hkv, S, D]
            sdpa = lambda kk, vv, **kw: F.scaled_dot_product_attention(
                q[:, :, None, :], kk, vv, attn_mask=mask, **kw)
            library_form = "head-major copy of the cache"
            if g > 1:
                try:        # GQA on the unrepeated cache, where torch takes it
                    sdpa(kh, vh, enable_gqa=True)
                    library_form += ", enable_gqa=True"
                    library = lambda: sdpa(kh, vh, enable_gqa=True)
                except (TypeError, RuntimeError):
                    kh, vh = (x.repeat_interleave(g, dim=1) for x in (kh, vh))
                    library_form += f", K/V repeated to {hq} heads"
                    library = lambda: sdpa(kh, vh)
            else:
                library = lambda: sdpa(kh, vh)
            library_ms = timer(library)
            log(f"[time]   with a read flush of the L2 (clean lines): kernel "
                f"{timer(kern, flush='read'):.4f} ms, sdpa {timer(library, flush='read'):.4f} ms")
        kv_rows = b * length * hkv                 # (row, KV head, position) read
        nbytes = (2 * kv_rows * d * k.element_size() + (2 * kv_rows * 2 if int8 else 0)
                  + 2 * q.numel() * q.element_size() + 4 * b)
        bound_ms, bound_by = bound(nbytes, 4 * b * length * hq * d,
                                   dev["int8_ops"] if int8 else dev["bf16_ops"])
        n_split = skv_ops.split_count(b, hkv, s, sm_count)
        sweep = {}
        for ns in range(1, skv_ops.MAX_SPLIT + 1):   # the wrapper's choice vs the others
            sweep[ns] = timer(lambda ns=ns: skv_ops.launch(q, k, v, lens, n_split=ns, **kw))
        if not int8 and hq == hkv:
            calibrate(nbytes)
        shape = (f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} len={length} "
                 f"{'int8+bf16 scales' if int8 else 'bf16'}")
        log(f"[time] swiftkv_decode{'_int8' if int8 else ''} {shape}: kernel {ms:.4f} ms "
            f"(n_split {n_split}), plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms if library_ms is None else round(library_ms, 4)} ms "
            f"({library_form}), bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
            f"max_abs_err {err:.3g}")
        log(f"[time]   by n_split: " + ", ".join(f"{ns}: {t:.4f}" for ns, t in sweep.items()))
        return {"shape": shape, "n_split": n_split, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "library_form": library_form}

    def back_to_back(x, qw, mbytes=256):
        """ms a call of the decode form as the decode step issues it: calls
        one after another on copies of the weight (~mbytes MB of them, so
        each reads its weight from device memory), no timer flush in
        between; one CUDA graph, the best of 5 replays."""
        n_copies = min(64, max(2, -(-(mbytes << 20) // qw.packed.numel())))
        packs = [qw.packed.clone() for _ in range(n_copies)]
        run = lambda: [gemv_ops.gemv_w4a8(x, p, qw.scale) for p in packs]
        run()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        best = float("inf")
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / n_copies)
        del graph, packs
        return best

    def gemv(m, k_dim, n, sweep=False):
        x = _rand(torch, gen, m, k_dim, dtype=torch.bfloat16)
        qw = quantize_w4(_rand(torch, gen, k_dim, n, dtype=torch.float32) * 0.02)
        kern = lambda: gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
        plain = lambda: gemv_ref.gemv_w4a8_ref(x, qw.packed, qw.scale)
        err = (kern() - plain()).abs().max().item()
        ms, plain_ms = timer(kern), timer(plain)
        # yardstick, not the same function: bf16 matmul on the dequantized weight
        w = (unpack_w4(qw.packed).float().reshape(-1, GROUP, n) * qw.scale[:, None, :])
        w = w.reshape(-1, n)[:k_dim].to(torch.bfloat16)
        dense_ms = timer(lambda: x @ w)
        nbytes = (x.numel() * x.element_size() + qw.packed.numel() + 4 * qw.scale.numel()
                  + 4 * m * n)
        bound_ms, bound_by = bound(nbytes, 2 * m * k_dim * n, dev["int8_ops"])
        row = {"shape": f"M={m} K={k_dim} N={n}", "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        form = ""
        if m <= gemv_ops.DECODE_MAX_M:
            tile_bytes, ks = gemv_ops.decode_plan(m, k_dim, n, sm_count)
            row.update(tile_bytes=tile_bytes, ks=ks, read_flush_ms=timer(kern, flush="read"),
                       stream_ms=back_to_back(x, qw))
            form = (f" (decode form, tile {tile_bytes} B, ks {ks}; "
                    f"{row['read_flush_ms']:.4f} ms with a read flush, "
                    f"{row['stream_ms']:.4f} ms a call back to back)")
        log(f"[time] gemv_w4a8 M={m} K={k_dim} N={n}: kernel {ms:.4f} ms{form}, plain "
            f"{plain_ms:.4f} ms, dense bf16 matmul (not the same function) {dense_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
            f"max_abs_err {err:.3g}")
        if sweep:                # the plan's grid against the others
            for tb in gemv_ops.TILE_BYTES:
                times = [timer(lambda ks=ks: gemv_ops.launch_decode(
                    x, qw.packed, qw.scale, tile_bytes=tb, ks=ks))
                    for ks in range(1, min(gemv_ops.MAX_RANKS, -(-k_dim // GROUP)) + 1)]
                log(f"[time]   tile {tb} B by ks 1..{len(times)}: "
                    + ", ".join(f"{t:.4f}" for t in times))
        return row

    # leg A decodes lengths 513..576 in a 640-slot cache; leg B 129..192 in 256
    skv_a = swiftkv(8, 32, 32, 640, 128, 576, int8=False)
    skv_b = swiftkv(8, 32, 32, 256, 128, 192, int8=True)
    skv_b576 = swiftkv(8, 32, 32, 640, 128, 576, int8=True)   # int8 at leg A's length
    skv_gqa = swiftkv(8, 32, 8, 640, 128, 576, int8=False)    # qwen3-8b GQA 32/8
    gemv_rows = {}
    decode_shapes = ((4096, 4096), (4096, 11008), (11008, 4096))
    for k_dim, n in decode_shapes:                       # leg B's decode step, M = batch
        gemv_rows[(8, k_dim, n)] = gemv(8, k_dim, n, sweep=True)
    gemv_rows[(8, 4096, 1024)] = gemv(8, 4096, 1024, sweep=True)   # qwen3-8b's K/V
    for k_dim, n in decode_shapes:                       # leg B's prefill, 8 x 128 rows
        gemv_rows[(1024, k_dim, n)] = gemv(1024, k_dim, n)

    la, lb = legs["legA"]["launches"], legs["legB"]["launches"]
    csrc = "src/repro_torch/csrc/"
    # launches: the serving runs' count of that kernel; the rows at the
    # int8 len 576 and GQA 32/8 shapes time the same kernels off the path
    skv = {"route": "cuda", "source": csrc + "swiftkv_decode.cu",
           "replaces": "src/repro/kernels/swiftkv_decode/kernel.py:140"}
    n_skv = la["swiftkv_decode"] + lb["swiftkv_decode"]
    n_int8 = la["swiftkv_decode_int8"] + lb["swiftkv_decode_int8"]
    rows = [
        {"name": "swiftkv_decode", **skv, "launches": n_skv, **skv_a},
        {"name": "swiftkv_decode_int8", **skv, "launches": n_int8, **skv_b},
        {"name": "swiftkv_decode_int8", **skv, "launches": n_int8, **skv_b576},
        {"name": "swiftkv_decode", **skv, "launches": n_skv, **skv_gqa},
    ]
    gemv_src = {"route": "cuda", "source": csrc + "gemv_w4a8.cu",
                "replaces": "src/repro/kernels/gemv_w4a8/kernel.py:66"}
    n_dec = la["gemv_w4a8_decode"] + lb["gemv_w4a8_decode"]
    rows += [{"name": "gemv_w4a8_decode", **gemv_src, "launches": n_dec,
              **gemv_rows[(8, k, n)]} for k, n in decode_shapes + ((4096, 1024),)]
    rows += [{"name": "gemv_w4a8", **gemv_src, "launches": la["gemv_w4a8"] + lb["gemv_w4a8"],
              **gemv_rows[(1024, 4096, 11008)]}]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="also break each leg's decode step down (eager vs CUDA-graph "
                         "replay vs profiler kernel time and count, and its bytes bound)")
    ap.add_argument("--breakdown-only", action="store_true",
                    help="build the kernels and break each leg's decode step down, with "
                         "no check, serving run or timing (a before/after of two trees)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    resolve_device()                                  # also pins f32 matmul precision
    t_start = time.perf_counter()
    dev = phase_device(torch)
    phase_build()
    if args.breakdown_only:
        phase_legs(torch, dev, True, breakdown_only=True)
        log(f"[done] breakdown only, in {time.perf_counter() - t_start:.1f} s")
        return 0
    phase_kernel_checks(torch)
    phase_reduced_models(torch)
    legs = phase_legs(torch, dev, args.breakdown)
    rows = phase_timings(torch, dev, legs)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
