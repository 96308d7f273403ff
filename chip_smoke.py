#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--breakdown]

Needs one NVIDIA GPU (Hopper, sm_90a) and the CUDA toolkit's nvcc. It:

1. prints the card (name and power limit as nvidia-smi gives them) and the
   torch / CUDA / nvcc versions;
2. builds both hand-written kernels from ``src/repro_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at edge cases, and the reduced models on the
   card against the same models on the CPU; first, the quantizers'
   scales (``quantize_a8``, ``quantize_kv``, ``quantize_w4``) on the card
   bitwise against the same functions on the CPU (with the mismatch count
   of the scalar-reciprocal form they replaced); ``swiftkv_decode`` also at
   every split of S over CTAs (n_split 1, 2, 3, 8 and its own choice)
   against the plain model of that split, and for bitwise-equal repeats
   and CUDA-graph replay; the calls that ``ops.kernel_form`` gives the GQA
   form on tensor cores (bf16 q, bf16 or int8 cache, G 2-8, D a multiple
   of 16; ``csrc/swiftkv_decode_mma.cu``), among them new bf16 and int8
   cases at D 80 and 128 for G 2, 4 and 8, linear, windowed and ring, at
   every n_split 1-8 against the dense oracle and that form's model
   (``swiftkv_decode_mma_ref``); the decode form of ``gemv_w4a8`` (M <= 8) at
   every M 1-8, K and N of the path and edge shapes, f32 and bf16 x, every
   cluster size and tile width, against the plain version and the plain
   model of its split of K, its row scales bitwise equal to the CPU
   ``quantize_a8``'s, rows on the quantizer's edges, repeats and replay;
   the prefill form (M > 8) at M 9-1024 x the path's and edge K, N x f32
   and bf16, its quantize kernel's codes and scales bitwise equal to the
   CPU ``quantize_a8``'s, repeats and replay; the ring form of
   ``swiftkv_decode`` (``ring=True``) at f32, bf16 and int8 caches, G 1, 2,
   4 and 8, D 16-128, rings of 6, 128 and 4224 slots, windows below R and
   of R - 1, lengths 0, 1, window +- 1, R - 1, R, R + 1 and 3R + 5 in one
   batch, at every n_split against the dense oracle and the plain model of
   that split, and bit for bit equal to the linear windowed form on the
   unrolled cache; repeats and replay at leg D's shape; the LUT form
   (``exp_mode="lut"``): its exponential (the kernel's device function,
   through ``ops.exp_lut``) bitwise ``ref.exp_lut_kernel`` on ~1M points
   of [-200, 0] and the edges, and the form itself at f32, bf16 and int8
   caches, G 1, 4 and 8, D 64, 80 and 128, linear, windowed and ring, at
   every n_split against the model of the kernel's fold order, the
   softmax oracle and the native form, the ring bitwise its linear LUT
   form; the reduced h2o-danube-1.8b, +ring and +ring+w4a8 (a prompt
   longer than the ring) card against CPU;
4. leg A: serves llama2-7b at its published width (all 32 layers, bf16,
   random weights from a seed) through ``ServingEngine`` with
   ``decode_impl="kernel"`` — batch 8, prompt 512, 64 greedy steps — and
   checks that every decode attention went through the CUDA kernel;
5. leg B: the same for ``llama2-7b+w4a8`` (weights quantized on the card,
   int8 KV cache) — batch 8, prompt 128, 64 steps — checking the launch
   counts: one decode-form GEMV per decode-step projection, one quantize
   and one GEMM launch per prefill projection, int8 attention;
   after each leg, a prefill and a decode step of the kernel path are held
   against the plain path, and in float32 every kernel call of them against
   its plain version on the same inputs; ``--breakdown`` also splits the
   decode step's time (eager, CUDA-graph replay, profiler kernel time) and
   counts its device kernels;
4b. leg F: llama2-7b on leg A's weights with ``decode_impl="tokenwise"``
   (the paper-literal per-token recurrence, plain PyTorch): batch 8,
   prompt 64, max_len 128, 16 greedy steps, no kernel launch, logits
   teacher-forced against the kernel path's, flips only at near-ties;
4c. leg SP1 (right after leg A, on its weights): a one-rank NCCL world, its
   (data 1, model 1) mesh set as the distribution context, llama2-7b with
   ``decode_impl="sp"`` (each rank folds its slice of the cache, one
   all-gather of the (mu, Z, Y) states merges them): batch 8, prompt 512,
   32 greedy steps, tokens equal to the blockwise run's without a
   context, teacher-forced logits within 1e-3 of the range, no kernel
   launch, one all-gather a layer and step; then ``decode_attention_sp``
   alone at leg A's shape beside the fold and the plain version;
6. leg C, continuous serving at the same width: ``ContinuousBatchingEngine``
   (8 slots, max_len 1024, chunk 128, decode_ticks 8, greedy) over a
   backlogged ``poisson_trace`` of 16 requests, for llama2-7b on leg A's
   weights (C1) and llama2-7b+w4a8 on leg B's (C2), with six checks: every
   request retires with its budget; the launch counts equal the engine's
   counters; three requests run alone and four at decode_ticks 1 and 8
   get bitwise their tokens; a decode_multi block runs with no host
   synchronization; and (printed) the first 2 requests' agreement with
   lock-step;
6b. legs D and E, ring-KV sliding-window serving of h2o-danube-1.8b at its
   published width (24 layers, d 2560, 32/8 heads of 80, window 4096,
   random bf16 weights from seed 0): D1 ``h2o-danube-1.8b+ring`` lock-step,
   batch 8, prompt 4160, 128 greedy steps (a 4224-slot ring that wraps at
   step 64), every decode attention the ring form of the kernel, kernel
   path against plain path, and every step's logits bit for bit those of
   the linear twin ``h2o-danube-1.8b`` (max_len 4352) on the same weights,
   both decoding through the GQA form (24 launches a step);
   D2 the same for ``+ring+w4a8`` (int8 ring, GEMV launch counts, no twin);
   E ``+ring`` continuous (4 slots, max_len 6144, chunk 128, decode_ticks
   8, 8 backlogged requests of 3968-5120-token prompts that wrap the ring
   in chunked prefill): leg C's checks (two requests alone), a slot reused
   after a wrapped occupant, and the ring's rows against the twin's;
6c. the other dense configs and the MoE family at published width
   (random bf16 weights from seed 0, each leg's freed before the next):
   G1 ``chatglm-6b`` lock-step (batch 8, prompt 512, 64 steps; the fold,
   28 launches a step), H ``chatglm-6b`` continuous (leg C's setup and
   checks), G2 ``chatglm-6b+w4a8`` (prompt 128: 6 decode-form GEMVs a
   layer-step, no gate), I ``gemma-2b`` (MQA: the GQA form at G 8, D 256,
   one KV head), J ``mistral-nemo-12b`` (the GQA form at G 4, D 128; 32
   steps), M1 ``olmoe-1b-7b`` (64 experts top-8; the fold; its prefill's
   dropped assignments printed), EP1 (M1's weights and prompts again
   under a one-rank (1, 1) context: the prefill's experts through the
   expert-parallel route, one all-reduce a MoE layer; tokens and dropped
   share bitwise M1's) and M2 ``olmoe-1b-7b`` continuous; every
   lock-step leg's kernel path against its plain path (on olmoe in bf16
   against a witness whose decode attention moved by one rounding);
   also reduced chatglm-6b+w4a8, gemma-2b, mistral-nemo-12b, olmoe-1b-7b
   and llama4-scout+w4a8 card against CPU, llama2-7b's sampled tokens
   (temperature 0.8, key ``prng_key(0)``) card against CPU, and the GQA
   form at llama4-scout's G 5 (bf16, int8) and gemma-2b's decode shape
   at every n_split;
6d. the recurrent families at published width (random bf16 weights from
   seed 0): hymba-1.5b (attention and a Mamba branch side by side, 25/5
   heads of 64, window 1024) as K1 ``+ring`` lock-step (batch 8, prompt
   1088, 128 steps: a 1152-slot ring that wraps at step 64; the GQA form
   at G 5, bitwise its linear twin ``hymba-1.5b``), L ``+ring``
   continuous (4 slots, max_len 2048, 8 prompts of 1216-1792 tokens, all
   past the ring; leg E's checks) and K2 ``+ring+w4a8`` (7 decode-form
   GEMVs a layer-step at K 1600, a ragged last group); rwkv6-3b (RWKV6: no
   KV cache, no kernel) as R1 lock-step (batch 8, prompt 512, 64 steps;
   lock-step prefill state against chunked prefill state), S continuous
   (leg C's setup and checks) and R2 ``+w4a8`` (prompt 128: wk/wv/wo, 3
   decode-form GEMVs a layer-step); also reduced rwkv6-3b, rwkv6-3b+w4a8,
   hymba-1.5b, +ring and +ring+w4a8 card against CPU, the GQA form at
   hymba's shapes (G 5, D 64, window 1024, linear and ring, bf16 and int8)
   at every n_split, and the GEMV at K 1600, N 320 and 2560 -> 2560;
6e. the cross-attention configs (random bf16 weights from seed 0, every
   cross gate 0.5: at the reference's init of 0 the cross terms vanish):
   whisper-small at full size (the fold, G 1) as W1 lock-step (batch 8,
   sources 8 x 1500 x 768 with lengths 375-1500, prompt 64, 64 steps; 12
   self and 12 per-row cross reads a step) and W2 continuous (8 slots,
   max_len 512, chunk 64, decode_ticks 8, 16 requests with sources of
   375-1500 frames shared by pairs: the pooled reads); llama-3.2-vision-90b
   at depth 20 of 100 (16 self and 4 cross layers, every width the
   published one; the GQA form, G 8, D 128) as V1 lock-step bf16 (batch 8,
   sources 8 x 1600 x 8192 with lengths 400-1600, prompt 512, 32 steps)
   and V2 ``+w4a8`` continuous (leg C's setup, sources of 400-1600 shared
   by pairs: the int8 pool) on V1's weights quantized; the lock-step legs
   hold each cross read alone against the oracle and always print their
   decode-step breakdown; the continuous legs print ``source_ingests`` /
   ``source_shares`` and hold the pooled read alone against the oracle;
   also the pooled form (``entries=``) of both kernel files at whisper's
   and vision's shapes, bitwise the read of the gathered per-row copy at
   every n_split, and reduced whisper-small, llama-3.2-vision-90b and
   their ``+w4a8`` card against CPU, lock-step and continuous;
6f. the serving extras, on leg C1's model and weights (after leg C1) and
   leg W2's engine (after leg W2), no model loaded again, every run
   launch-counted against the engine's counters: T1 leg C's setup and trace
   with ``telemetry=Telemetry(jsonl_path=...)`` and ``auditor=
   EngineAuditor()`` (tokens bitwise C1's untraced run, event counts equal
   to the report's counters, the JSONL reloaded, the Chrome trace written
   under ``build/serving_extras/`` and parsed back, audits > 0; tokens/s
   with and without telemetry); T2 T1's engine under a ``FaultPlan`` (a
   ``poison_nan`` victim at block 2 quarantined ``nonfinite_logits`` on the
   device, a ``tick_delay``, a ``dispatch_fail`` retried; bystanders
   bitwise C1's, no slot held, ``plan.replay()`` the same report), then a
   cancel of an in-flight request and a drain, each at the run's 4th step;
   T3 one ``ingest_fail`` victim on W2's engine (no token, bystanders
   bitwise W2's, both pools empty);
6g. training, which launches neither kernel (the counts stay 0): TR2 the
   reduced h2o-danube-1.8b (float32), one train step on the card against
   the CPU's (loss, every gradient leaf, the AdamW update), then under
   deterministic algorithms a 6-step run checkpointing every 3 steps
   against a 3-step run resumed to 6 and a run whose step 4 fails once,
   losses bitwise equal; TR1 h2o-danube-1.8b at full size (float32
   masters, bf16 compute, remat "full") through ``TrainLoop``, 6 steps of
   8 x 1024 counted tokens: finite losses and gradient norms, the last
   loss below the first; prints tokens/s, the median step, the peak memory
   and the model-FLOP share; FS1 TR1's setup through
   ``make_train_step(param_specs=)`` on ``DTensor`` s over the one-rank
   NCCL world's (1, 1) mesh (``launch.train.shard_train_state``, the batch
   sharded over data), 3 steps: each loss against TR1's on the same batch
   (step 0 bitwise, then 1e-4 relative: the embedding's bf16 backward
   rounds apart), every leaf still placed by its
   spec, the median step beside TR1's, the peak memory, no kernel launch;
6h. one line of digests of leg A's tokens (which SP1's equal), C1's,
   M1's (which EP1's equal) and TR1's and FS1's losses, to hold two trees
   to each other; then, after the timings of 7., the dry run of the
   distribution layer (``repro_torch.launch.dryrun``, no card: rank 0 of
   torch's ``fake`` world of 256 / 512 ranks in one process, meta
   tensors) in two subprocesses at once: the cost pass of qwen3-8b
   decode_32k at full width and the multi-pod scan pass of reduced
   whisper-small train_4k, each ``ok``, one line a cell; then phase
   examples: every ``examples/torch_*.py`` ``main`` on the card at its
   defaults (quickstart, serve_decode, serve_continuous, train_lm, also at
   d_model 512 x 12 layers for 50 steps, and multi_arch_smoke), their own
   assertions
   and one line each; the decode kernel launched by quickstart and by
   serve_decode's kernel impl, its plain version never called; then
   ``linear_w4a8`` (bf16, a bias, K 4096 -> N 4096) at M 1 and 64 against
   its plain version;
7. times each kernel, its plain version and a PyTorch library call at the
   serving path's shapes (CUDA events around CUDA-graph replays, median of
   25, L2 flushed before each), beside the least time the card could take;
   ``swiftkv_decode`` also at every n_split, with a read flush of the L2,
   and beside the timer's own floor and a plain read of the same bytes,
   its ring form (bf16, int8) and linear windowed form at leg D's decode
   shape beside SDPA with the window's boolean mask, the rows the GQA form
   takes beside the fold on the same call (``ops.launch(form="fold")``),
   and its LUT form at the shapes of legs A, B and D (bf16 and int8),
   and the GQA form at gemma-2b's decode shape (leg I) and hymba-1.5b's
   ring (legs K1, K2, bf16 and int8) beside SDPA with ``enable_gqa=True``,
   the cross reads per-row (W1, V1) and pooled (W2, V2, bf16 and int8)
   beside SDPA (pooled: over an ``index_select`` copy, the copy included);
   the decode form of ``gemv_w4a8`` also with a read flush and at every
   tile width and cluster size (at chatglm-6b's MLP shapes, K 4096 -> N
   16384 and 16384 -> 4096, and at hymba-1.5b's and rwkv6-3b's K 1600
   and 5504, N 320, 1600, 5504 and 2560, and llama-3.2-vision-90b's 8192
   -> 8192 / 1024 / 28672 and 28672 -> 8192, in both forms, without the
   sweep);
   the prefill form also split into its two
   kernels, and beside a dense bf16 matmul and
   ``torch._int_mm`` of the same shape (yardsticks, not the same function).

``--breakdown-only`` builds the kernels and runs only the decode-step
breakdowns and one timed prefill per lock-step leg, with no check: it uses nothing
but the model API, so it also runs from an older tree of the port, for a
before/after on one card.

It prints one line per phase, then a JSON line with every kernel's numbers,
the card line, and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a GPU it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
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


def _at_offset(torch, x, nbytes: int):
    """A copy of ``x`` that starts ``nbytes`` into its storage."""
    buf = torch.empty(x.numel() * x.element_size() + nbytes, dtype=torch.uint8,
                      device=x.device)
    out = buf[nbytes:].view(x.dtype).view(x.shape)
    out.copy_(x)
    return out


def _skv_plan(torch, q, k, window=None, k_scale=None):
    """The kernel form of a ``swiftkv_decode`` call (``ops.kernel_form``),
    the n_split its policy picks on this card, and the plain model of that
    form's fold (native exponential)."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    hq, d = q.shape[1:]
    form = skv_ops.kernel_form(hq // k.shape[2], d, q.dtype, k.dtype)
    model = skv_ref.swiftkv_decode_mma_ref if form == "mma" else skv_ref.swiftkv_decode_split_ref
    return form, skv_ops.split_plan(q, k, window, k_scale=k_scale), model


def _earlier_split(form, b, hkv, s, window, sm_count) -> int:
    """The n_split of the split policies that the occupancy model replaced,
    printed beside each n_split sweep: the fold kept its grid within one
    CTA per SM; the GQA form took about 2.5 CTAs per SM and at least 5 of
    its tiles to a split. Both at most 8 and at most one split a tile."""
    if form == "mma":
        n_pos = min(s, window) if window else s
        return max(1, min(int(2.5 * sm_count) // (b * hkv), -(-n_pos // 64) // 5, 8))
    return max(1, min(sm_count // (b * hkv), -(-s // 32), 8))


def phase_kernel_checks(torch) -> None:
    from repro_torch.core.quantization import quantize_w4
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    _check_quant_scales(torch)
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
    _check_swiftkv_ring(torch, gen)
    _check_swiftkv_pooled(torch, gen)
    _check_exp_lut(torch)
    _check_swiftkv_lut(torch, gen)

    # The integer group sums are exact on both sides; only the f32 sum over
    # groups differs in order: relative error ~ K/128 f32 roundings.
    for m in (1, 8, 1024):
        for k_dim, n in ((4096, 4096), (4096, 11008), (11008, 4096), (64, 96)):
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
    _check_gemv_prefill(torch, gen)


def _edge_rows(torch, k: int = 300):
    """Rows on the quantizer's edges (as tests/test_torch_gemv.py builds
    them): half-even ties at scale 1 (amax 127), an all-zero row, a row
    whose amax / 127 is not a bf16 value, one whose float-reciprocal
    product differs from the quotient, then random rows. [6, k] f32, CPU."""
    import numpy as np
    rng = np.random.default_rng(16)
    x = rng.standard_normal((6, k)).astype(np.float32)
    x[0] = 0.0
    x[0, :10] = [127.0, 2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 3.5, 126.5, -126.5]
    x[1] = 0.0
    x[2] *= 3.0 / np.abs(x[2]).max()
    cands = np.linspace(1, 2, 4001, dtype=np.float32)
    recip = cands[cands * (np.float32(1) / np.float32(127)) != cands / np.float32(127)][0]
    x[3] *= recip / np.abs(x[3]).max()
    return torch.from_numpy(x)


def _check_quant_scales(torch) -> None:
    """The port's quantizers on the card against the same functions on the
    CPU, bitwise: the scales (and codes) of quantize_a8 and quantize_kv,
    and quantize_w4's candidate and chosen scales, on randn(4096, 4096) and
    the edge rows, x in f32 and bf16. Beside each, the mismatch count of
    the form they replaced (a division by a Python scalar, which PyTorch's
    CUDA kernel turns into a multiply by the float reciprocal)."""
    from repro_torch.core import quantization as q
    gen = torch.Generator().manual_seed(5)
    inputs = {"randn(4096, 4096)": torch.randn(4096, 4096, generator=gen),
              "edge rows": _edge_rows(torch)}
    for what, x32 in inputs.items():
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            xc = x.cuda()
            amax_c = xc.abs().amax(dim=-1, keepdim=True)
            old = torch.where(amax_c > 0, amax_c / 127.0, 1.0).float().cpu()
            qa, sa = q.quantize_a8(x)
            qa_c, sa_c = (t.cpu() for t in q.quantize_a8(xc))
            a8_old = int((old != sa).sum())
            a8_new = int((sa_c != sa).sum())
            a8_codes = int((qa_c != qa).sum())
            kv_x = x.reshape(-1, 128) if x.shape[-1] % 128 == 0 else x
            kv_c = kv_x.cuda()
            amax_kv = kv_c.abs().amax(dim=-1)
            kv_old = torch.where(amax_kv > 0, amax_kv / 127.0, 0.0).float().cpu()
            qk, sk = q.quantize_kv(kv_x)
            qk_c, sk_c = (t.cpu() for t in q.quantize_kv(kv_c))
            kv_old_n = int((kv_old != sk).sum())
            kv_new = int((sk_c != sk).sum()) + int((qk_c != qk).sum())
            # quantize_w4 (weights [K, N]; x as a weight, its rows as K)
            w = x.float() * 0.02
            wg = torch.nn.functional.pad(w, (0, 0, 0, (-w.shape[0]) % q.GROUP))
            amax_w = wg.reshape(-1, q.GROUP, w.shape[1]).abs().amax(dim=1)
            amax_wc = amax_w.cuda()
            w4_old = sum(int((torch.where(amax_wc > 0, c * amax_wc / 7.0, 1.0).float().cpu()
                              != s).sum())
                         for c, s in zip(q._CLIP_CANDIDATES, q.w4_candidate_scales(amax_w)))
            w4_cand = sum(int((a.cpu() != b).sum()) for a, b in
                          zip(q.w4_candidate_scales(amax_wc), q.w4_candidate_scales(amax_w)))
            w4_new, w4_ties = _w4_choice_mismatches(torch, q, w, wg)
            log(f"[check] quantizer scales on the card vs the CPU, {what} {dt}: quantize_a8 "
                f"{a8_new} of {sa.numel()} differ (codes {a8_codes}; the scalar-reciprocal form: "
                f"{a8_old}), quantize_kv {kv_new} (reciprocal form: {kv_old_n} of {sk.numel()}), "
                f"quantize_w4 candidates {w4_cand} (reciprocal form: {w4_old} of "
                f"{5 * amax_w.numel()}) and chosen {w4_new}, besides {w4_ties} near-ties of "
                f"the clip search")
            if a8_new or a8_codes or kv_new or w4_cand or w4_new:
                raise AssertionError(f"quantizer scales on the card differ from the CPU's "
                                     f"({what}, {dt})")


def _w4_choice_mismatches(torch, q, w, wg) -> tuple[int, int]:
    """quantize_w4's chosen scales, card vs CPU: (groups that differ other
    than by a near-tie, near-ties). The clip search keeps the candidate of
    least squared error over the group; two candidates whose errors (sums
    of 128 f32 squares) lie within 1e-5 of each other, the reach of another
    summation order (~128 f32 roundings), may be picked either way, as the
    CPU tests against the reference allow (test_quantize_w4_exact_or_tie)."""
    want = q.quantize_w4(w).scale
    got = q.quantize_w4(w.cuda()).scale.cpu()
    groups = wg.reshape(-1, q.GROUP, w.shape[1])
    ties = 0
    for gi, ni in (got != want).nonzero().tolist():
        col = groups[gi, :, ni]
        errs = [float(((torch.clamp(torch.round(col / sc), -8, 7) * sc - col) ** 2).sum())
                for sc in (want[gi, ni], got[gi, ni])]
        ties += abs(errs[0] - errs[1]) <= 1e-5 * max(errs)
    return int((got != want).sum()) - ties, ties


def _gemv_err(torch, got, *wants):
    """Max |got - want| over ``wants``, and the tolerance: 1e-5 of max
    |want| (+1e-6). Integer group sums are exact on every side; only the
    f32 sum over groups differs in order, ~K/128 f32 roundings."""
    err = max((got - w).abs().max().item() for w in wants)
    return err, 1e-5 * max(w.abs().max().item() for w in wants) + 1e-6


# the W4A8 projections of hymba-1.5b (K 1600 = 12.5 groups of 128: attention
# 1600 -> 1600 and 1600 -> 320, MLP 1600 -> 5504 and 5504 -> 1600) and of
# rwkv6-3b (wk, wv, wo: 2560 -> 2560)
RECURRENT_GEMV_SHAPES = ((1600, 1600), (1600, 320), (1600, 5504), (5504, 1600), (2560, 2560))
# llama-3.2-vision-90b's projections: wq / wo, wk / wv, up / gate, down
VISION_GEMV_SHAPES = ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192))


def _check_gemv_decode(torch, gen) -> None:
    """The decode form (M <= 8, quantization inside, split-K in a cluster),
    where it can go wrong: every M 1-8 at each K (one group, a ragged
    second group, the path's 4096 and 11008) and N (96 and qwen3-8b's 1024
    besides the path's), x in f32 and bf16, against the plain version and
    the plain model of its split; its row scales bitwise equal to the CPU
    quantize_a8's; every cluster size and tile width; rows built on the
    quantizer's edges; bitwise repeats and CUDA-graph replay. Also the
    recurrent families' shapes: hymba-1.5b's K 1600 (12.5 groups: a ragged
    last group) to N 320, 1600 and 5504, its 5504 -> 1600, and rwkv6-3b's
    2560 -> 2560."""
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
        same_scales = torch.equal(scales.cpu(), quantize_a8(x.cpu())[1][:, 0])
        return got, want, model, same_scales

    def weights(k_dim, n):
        return quantize_w4(_rand(torch, gen, k_dim, n, dtype=f32) * 0.02)

    shapes = [(k, n) for k in (64, 200, 4096, 11008) for n in (96, 1024, 4096, 11008)]
    for k_dim, n in shapes + list(RECURRENT_GEMV_SHAPES):
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
                        f"or row scales differ from the CPU quantize_a8's ({same_scales})")
        log(f"[check] gemv_w4a8 decode K={k_dim} N={n} (tile {plan[0]} B, ks {plan[1]}): "
            f"M 1-8 x f32/bf16 within {worst:.3g} of the tolerance (1e-5 of max |out|) "
            f"of the plain version and the split model; row scales bitwise equal to "
            f"the CPU quantize_a8's")

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


def _check_gemv_prefill(torch, gen) -> None:
    """The prefill form (M > 8: quantize kernel, then the GEMM on int8
    tensor cores), where it can go wrong: M 9, 16, 64, 100, 1024 x the
    path's K, N (and qwen3-8b's 4096 -> 1024, and 200 -> 264, 64 -> 96:
    ragged groups, rows not 16-byte aligned) x f32 and bf16 x, against the
    plain version; the quantize kernel's codes and scales bitwise equal to
    the CPU quantize_a8's in the codes' layout (``ref.pack_codes``), on
    random and edge rows; repeats bitwise equal and CUDA-graph replay
    equal to eager."""
    from repro_torch.core.quantization import quantize_a8, quantize_w4
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    f32, bf16 = torch.float32, torch.bfloat16

    def same_codes(x, codes, scales):
        q, s = quantize_a8(x.cpu())
        return (torch.equal(codes.cpu(), gemv_ref.pack_codes(q))
                and torch.equal(scales.cpu(), s[:, 0]))

    shapes = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 1024), (200, 264), (64, 96),
              *RECURRENT_GEMV_SHAPES)
    for k_dim, n in shapes:
        qw = quantize_w4(_rand(torch, gen, k_dim, n, dtype=f32) * 0.02)
        worst = 0.0
        for dt in (f32, bf16):
            for m in (9, 16, 64, 100, 1024):
                x = _rand(torch, gen, m, k_dim, dtype=dt)
                codes, scales = gemv_ops.launch_quant(x)
                got = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)     # the wrapper's path
                torch.cuda.synchronize()
                want = gemv_ref.gemv_w4a8_ref(x, qw.packed, qw.scale)
                err, tol = _gemv_err(torch, got, want)
                worst = max(worst, err / tol)
                ok_codes = same_codes(x, codes, scales)
                if not (torch.isfinite(got).all().item() and err <= tol and ok_codes):
                    raise AssertionError(
                        f"gemv_w4a8 prefill M={m} K={k_dim} N={n} {dt}: err {err} > {tol} or "
                        f"codes / scales differ from the CPU quantize_a8's ({ok_codes})")
        log(f"[check] gemv_w4a8 prefill K={k_dim} N={n}: M 9/16/64/100/1024 x f32/bf16 within "
            f"{worst:.3g} of the tolerance (1e-5 of max |out|) of the plain version; codes and "
            f"scales bitwise equal to the CPU quantize_a8's")

    # the edge rows (ties, a zero row, bf16 and reciprocal edges) among 16
    qw = quantize_w4(_rand(torch, gen, 300, 256, dtype=f32) * 0.02)
    for dt in (f32, bf16):
        x = torch.cat([_edge_rows(torch), torch.randn(10, 300, generator=torch.Generator()
                                                      .manual_seed(6))]).to(dt).cuda()
        codes, scales = gemv_ops.launch_quant(x)
        got = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
        torch.cuda.synchronize()
        err, tol = _gemv_err(torch, got, gemv_ref.gemv_w4a8_ref(x, qw.packed, qw.scale))
        ok_codes = same_codes(x, codes, scales)
        log(f"[check] gemv_w4a8 prefill quantizer edge rows {dt}: codes and scales bitwise "
            f"equal to the CPU quantize_a8's {ok_codes}, max_abs_err {err:.3g} (tol {tol:.3g}), "
            f"zero row exactly 0 {(got[1] == 0).all().item()}")
        if not (ok_codes and err <= tol and (got[1] == 0).all().item()):
            raise AssertionError(f"gemv_w4a8 prefill quantizer edge rows ({dt}) differ")

    for k_dim, n, m in ((4096, 11008, 1024), (200, 264, 100)):
        qw = quantize_w4(_rand(torch, gen, k_dim, n, dtype=f32) * 0.02)
        x = _rand(torch, gen, m, k_dim, dtype=bf16)
        first = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
        second = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = gemv_ops.gemv_w4a8(x, qw.packed, qw.scale)
        graph.replay()
        torch.cuda.synchronize()
        log(f"[check] gemv_w4a8 prefill M={m} K={k_dim} N={n}: two launches bitwise equal "
            f"{torch.equal(first, second)}, CUDA-graph replay equal to the eager launch "
            f"{torch.equal(captured, first)}")
        if not (torch.equal(first, second) and torch.equal(captured, first)):
            raise AssertionError("gemv_w4a8 prefill: launches on the same inputs differ")
        del graph


def _check_swiftkv_split(torch, gen) -> None:
    """The split of S over CTAs, where it can go wrong: each case at
    n_split 1, 2, 3, 8 and the wrapper's own choice (every n_split 1-8 for
    the GQA form), against the plain version and against the plain model of
    the kernel form's fold at the same n_split (``swiftkv_decode_split_ref``
    or, for the cases ``ops.kernel_form`` gives the GQA form on tensor
    cores, ``swiftkv_decode_mma_ref``); ragged lengths leave whole chunks
    empty, windows put lo inside a tile, rows of length 0 must be an exact
    0. Then at leg A's shape and the GQA 32/8 one: two launches bitwise
    equal, and one launch captured in a CUDA graph and replayed equal to
    the eager launch."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    f32, bf16 = torch.float32, torch.bfloat16
    t = skv_ops.TILE
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
        # the GQA form's shapes: bf16 q, bf16 or int8 caches, D 80 and 128, G 2-8
        ("bf16 G=2 D=80 window 100", 6, 16, 8, 640, 80, bf16, 100, None,
         [640, 300, 101, 99, 1, 0], 1e-2),
        ("bf16 G=4 D=80 ragged", 5, 32, 8, 640, 80, bf16, None, None,
         [0, 1, 63, 64, 640], 1e-2),
        ("bf16 G=8 D=128 window 200", 4, 64, 8, 640, 128, bf16, 200, None,
         [640, 333, 199, 0], 1e-2),
        ("int8+bf16 scales G=4 D=80 ragged", 5, 32, 8, 640, 80, bf16, None, bf16,
         [0, 1, 65, 500, 640], 1e-2),
        ("int8+f32 scales G=2 D=128 window 100", 4, 16, 8, 640, 128, bf16, 100, f32,
         [640, 150, 64, 0], 1e-2),
        ("int8+bf16 scales G=8 D=128", 3, 64, 8, 640, 128, bf16, None, bf16,
         [1, 320, 640], 1e-2),
        ("int8+bf16 scales G=4 D=80 S=100 (scales read in place)", 3, 16, 4, 100, 80, bf16,
         None, bf16, [0, 99, 100], 1e-2),
        ("int8+bf16 scales G=4 D=80, caches aligned to 8 bytes only (8-byte copies)", 3, 16,
         4, 256, 80, bf16, None, bf16, [0, 131, 256], 1e-2),
        ("bf16 G=3 D=96 window 60", 3, 6, 2, 160, 96, bf16, 60, None, [0, 97, 160], 1e-2),
        ("bf16 G=8 D=256", 2, 16, 2, 128, 256, bf16, None, None, [128, 70], 1e-2),
        # llama4-scout's group of 5 (40/8 heads), and gemma-2b's decode (MQA,
        # 8 heads of 256 on one KV head, batch 8, leg I's cache of 640 rows)
        ("bf16 G=5 D=128 ragged", 4, 40, 8, 640, 128, bf16, None, None, [0, 1, 333, 640],
         1e-2),
        ("int8+bf16 scales G=5 D=128 window 200", 4, 40, 8, 640, 128, bf16, 200, bf16,
         [640, 201, 64, 0], 1e-2),
        ("gemma-2b decode: bf16 G=8 D=256 Hkv=1 B=8 ragged", 8, 8, 1, 640, 256, bf16, None,
         None, [513, 576, 0, 1, 64, 300, 575, 640], 1e-2),
        # hymba-1.5b's decode (25 heads of 64 on 5 KV heads, window 1024) on
        # leg K1's linear twin's cache of 1280 rows, bf16 and int8
        ("hymba-1.5b decode: bf16 G=5 D=64 Hkv=5 B=8 window 1024", 8, 25, 5, 1280, 64, bf16,
         1024, None, [1089, 1216, 0, 1, 1025, 1280, 700, 1100], 1e-2),
        ("hymba-1.5b+w4a8 decode: int8+bf16 scales G=5 D=64 window 1024", 8, 25, 5, 1280, 64,
         bf16, 1024, bf16, [1089, 1216, 0, 1, 1025, 1280, 700, 1100], 1e-2),
    ]
    for name, b, hq, hkv, s, d, dt, win, sc_dt, lens, atol in cases:
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, dt,
                                               int8=sc_dt is not None, lengths=lens,
                                               scale_dtype=sc_dt)
        if "8 bytes only" in name:         # the same caches, 8 bytes into their storage
            k, v = (_at_offset(torch, x, 8) for x in (k, v))
        form, own, model_fn = _skv_plan(torch, q, k, win, kw.get("k_scale"))
        want = skv_ref.swiftkv_decode_ref(q, k, v, lengths, window=win, **kw).float()
        errs = []
        for n_split in (*(range(1, 9) if form == "mma" else (1, 2, 3, 8)), None):
            ns = n_split or own
            out = skv_ops.launch(q, k, v, lengths, window=win, n_split=n_split, **kw)
            torch.cuda.synchronize()
            model = model_fn(q, k, v, lengths, n_split=ns, window=win, **kw).float()
            err = max((out.float() - want).abs().max().item(),
                      (out.float() - model).abs().max().item())
            errs.append(f"{ns}{'' if n_split else ' (own)'}: {err:.3g}")
            zero_rows = [i for i, n in enumerate(lens) if n == 0]
            if not (torch.isfinite(out).all().item() and err <= atol
                    and all((out[i] == 0).all().item() for i in zero_rows)):
                raise AssertionError(f"swiftkv_decode split {name} n_split={ns}: err {err} "
                                     f"> {atol} or a length-0 row not exactly 0")
        log(f"[check] swiftkv_decode split {name} ({form} form): max_abs_err vs plain and vs "
            f"the model of its fold by n_split {{{', '.join(errs)}}} (atol {atol:g}; length-0 "
            "rows exact 0)")

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
        form, n_split, _ = _skv_plan(torch, q, k)
        same = torch.equal(first, second) and torch.equal(captured, first)
        log(f"[check] swiftkv_decode {name} shape ({form} form, n_split {n_split}): two "
            f"launches bitwise equal {torch.equal(first, second)}, CUDA-graph replay equal to "
            f"the eager launch {torch.equal(captured, first)}")
        if not same or not (first[-1] == 0).all().item():
            raise AssertionError(f"swiftkv_decode {name}: launches on the same inputs "
                                 f"differ, or a length-0 row is not exactly 0")
        del graph


def _check_swiftkv_ring(torch, gen) -> None:
    """The ring form (``ring=True``), where it can go wrong: rings of 128
    and 4224 slots (leg D's) and of 6, f32, bf16 and int8 caches, G 1, 2, 4
    and 8, D 80 and 128 (16, 24 and 80 at R 6), windows below R and of
    R - 1; in one batch the lengths 0, 1, window - 1, window + 1, R - 1, R,
    R + 1 (the first wrap) and 3R + 5 (wrapped three times), so tiles
    straddle the wrap and rows lie on both sides of it. At n_split 1, 2, 3,
    8 and the wrapper's own choice (every n_split 1-8 for the GQA form on
    tensor cores): the dense oracle and the plain model of the kernel
    form's fold at that split within the tolerance, an exact 0 for length
    0, and the linear windowed form at the same n_split on the unrolled
    cache (position t at index t, read from slot t mod R) equal bit for
    bit: the kernel folds a ring's positions in the same tiles and order as
    the linear form's. Then, at leg D's decode shape with rows on both
    sides of the wrap: two launches bitwise equal and a CUDA-graph replay
    equal to the eager launch, bf16 and int8."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    f32, bf16 = torch.float32, torch.bfloat16
    # name, Hq, Hkv, R, D, q/cache dtype, window, int8 scale dtype (or None), atol
    cases = [
        ("f32 G=4 D=80 R=128 window 100", 32, 8, 128, 80, f32, 100, None, 1e-5),
        ("f32 G=1 D=128 R=128 window R-1", 8, 8, 128, 128, f32, 127, None, 1e-5),
        ("bf16 G=8 D=80 R=128 window 64", 64, 8, 128, 80, bf16, 64, None, 1e-2),
        ("int8+bf16 scales G=4 D=80 R=128 window R-1, f32 q", 32, 8, 128, 80, f32, 127,
         bf16, 1e-5),
        ("f32 G=4 D=80 R=4224 window 4096 (leg D)", 32, 8, 4224, 80, f32, 4096, None, 1e-5),
        ("bf16 G=4 D=80 R=4224 window R-1", 32, 8, 4224, 80, bf16, 4223, None, 1e-2),
        ("int8+bf16 scales G=4 D=80 R=4224 window 4096, f32 q", 32, 8, 4224, 80, f32,
         4096, bf16, 1e-5),
        ("int8+bf16 scales G=1 D=128 R=4224 window R-1, bf16 q", 8, 8, 4224, 128, bf16,
         4223, bf16, 1e-2),
        ("f32 G=8 D=128 R=4224 window 4096", 64, 8, 4224, 128, f32, 4096, None, 1e-5),
        # a ring of fewer slots than a warp's rows per step, S % 8 != 0
        ("f32 G=2 D=16 R=6 window 5", 4, 2, 6, 16, f32, 5, None, 1e-5),
        ("int8+f32 scales G=2 D=24 R=6 window 5 (8-byte copies, scales in place)", 4, 2,
         6, 24, f32, 5, f32, 1e-5),
        # the GQA form's shapes: bf16 q, bf16 or int8 caches, D 80 and 128, G 2-8
        ("bf16 G=4 D=80 R=4224 window 4096 (leg D1)", 32, 8, 4224, 80, bf16, 4096, None,
         1e-2),
        ("int8+bf16 scales G=4 D=80 R=4224 window 4096, bf16 q (leg D2)", 32, 8, 4224, 80,
         bf16, 4096, bf16, 1e-2),
        ("bf16 G=2 D=80 R=128 window 100", 16, 8, 128, 80, bf16, 100, None, 1e-2),
        ("int8+f32 scales G=8 D=80 R=128 window 127", 64, 8, 128, 80, bf16, 127, f32, 1e-2),
        ("bf16 G=8 D=128 R=4224 window 4096", 64, 8, 4224, 128, bf16, 4096, None, 1e-2),
        ("int8+bf16 scales G=2 D=128 R=4224 window R-1", 16, 8, 4224, 128, bf16, 4223, bf16,
         1e-2),
        ("int8+bf16 scales G=4 D=80 R=6 window 5 (scales read in place)", 8, 2, 6, 80, bf16,
         5, bf16, 1e-2),
        ("bf16 G=2 D=16 R=6 window 5", 4, 2, 6, 16, bf16, 5, None, 1e-2),
        # hymba-1.5b's ring (legs K1, K2): round128(1024 + 1) = 1152 slots
        ("bf16 G=5 D=64 R=1152 window 1024 (leg K1)", 25, 5, 1152, 64, bf16, 1024, None, 1e-2),
        ("int8+bf16 scales G=5 D=64 R=1152 window 1024, bf16 q (leg K2)", 25, 5, 1152, 64,
         bf16, 1024, bf16, 1e-2),
    ]
    for name, hq, hkv, r, d, dt, win, sc_dt, atol in cases:
        lens = [0, 1, win - 1, win + 1, r - 1, r, r + 1, 3 * r + 5]
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, len(lens), hq, hkv, r, d, dt,
                                               int8=sc_dt is not None, lengths=lens,
                                               scale_dtype=sc_dt)
        form, own, model_fn = _skv_plan(torch, q, k, win, kw.get("k_scale"))
        want = skv_ref.swiftkv_decode_ref(q, k, v, lengths, window=win, ring=True,
                                          **kw).float()
        ku, vu = (skv_ref.unroll_ring(x, lengths, 1) for x in (k, v))
        kwu = {n: skv_ref.unroll_ring(x, lengths, 2) for n, x in kw.items()}
        errs, bitwise = [], True
        for n_split in (*(range(1, 9) if form == "mma" else (1, 2, 3, 8)), None):
            ns = n_split or own
            out = skv_ops.launch(q, k, v, lengths, window=win, ring=True, n_split=n_split,
                                 **kw)
            linear = skv_ops.launch(q, ku, vu, lengths, window=win, n_split=ns, **kwu)
            torch.cuda.synchronize()
            model = model_fn(q, k, v, lengths, n_split=ns, window=win, ring=True,
                             **kw).float()
            err = max((out.float() - want).abs().max().item(),
                      (out.float() - model).abs().max().item())
            same = torch.equal(out, linear)
            bitwise &= same
            errs.append(f"{ns}{'' if n_split else ' (own)'}: {err:.3g}")
            if not (torch.isfinite(out).all().item() and err <= atol
                    and (out[0] == 0).all().item() and same):
                raise AssertionError(f"swiftkv_decode ring {name} n_split={ns}: err {err} > "
                                     f"{atol}, a length-0 row not exactly 0, or not bitwise "
                                     f"the linear form on the unrolled cache ({same})")
        log(f"[check] swiftkv_decode ring {name} ({form} form), lengths {lens}: max_abs_err "
            f"vs the dense oracle and vs the model of its fold by n_split "
            f"{{{', '.join(errs)}}} (atol {atol:g}); bitwise equal to the linear windowed "
            f"form on the unrolled cache at every n_split: {bitwise}; length 0 exact 0")

    for name, int8 in (("bf16", False), ("int8+bf16 scales", True)):
        lens = [4161, 4224, 4225, 4250, 4288, 2 * 4224 + 5, 1, 0]
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, 8, 32, 8, 4224, 80, bf16,
                                               int8=int8, lengths=lens)
        run = lambda: skv_ops.swiftkv_decode(q, k, v, lengths, window=4096, ring=True, **kw)
        first, second = run(), run()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = run()
        graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(first, second) and torch.equal(captured, first)
        form, n_split, _ = _skv_plan(torch, q, k, 4096, kw.get("k_scale"))
        log(f"[check] swiftkv_decode ring {name} at leg D's shape ({form} form, n_split "
            f"{n_split}): two launches bitwise equal {torch.equal(first, second)}, CUDA-graph "
            f"replay equal to the eager launch {torch.equal(captured, first)}")
        if not same or not (first[-1] == 0).all().item():
            raise AssertionError(f"swiftkv_decode ring {name}: launches on the same inputs "
                                 "differ, or a length-0 row is not exactly 0")
        del graph


def _check_swiftkv_pooled(torch, gen) -> None:
    """The pooled form (``entries=``: k/v a source-KV pool [E, S, Hkv, D],
    row b reading entry ``entries[b]``), in both kernel files, at the cross
    reads' shapes: the fold at whisper-small's (B 8, Hkv 12, G 1, D 64, S
    1500, bf16; S % 8 != 0, so int8 scales are read in place) and an f32
    case, the GQA form at llama-3.2-vision-90b's (B 8, Hkv 8, G 8, D 128, S
    1600, bf16 and int8 + bf16 scales) and int8 at S 1500. E = 16 > B = 8:
    entries reach past B, rows 1 and 5 share an entry, an entry has
    ``src_len`` 0. At n_split 1, 2, 3, 8 and the wrapper's own: bit for
    bit the same kernel on the gathered per-row copy ``k[entries]`` (the
    pooled form changes only a row's base address), within the tolerance
    of the dense oracle and of the plain model of the form's fold, the
    length-0 row an exact 0. Then the own split captured in a CUDA graph
    and replayed equal to the eager launch."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    f32, bf16 = torch.float32, torch.bfloat16
    # name, Hq, Hkv, S, D, dtype, int8 scale dtype (or None), atol
    cases = [
        ("whisper-small cross: fold, bf16 G=1 D=64 S=1500", 12, 12, 1500, 64, bf16, None,
         1e-2),
        ("whisper-small+w4a8 cross: fold, int8+bf16 scales S=1500 (scales in place)", 12, 12,
         1500, 64, bf16, bf16, 1e-2),
        ("fold, f32 G=4 D=64 S=300", 16, 4, 300, 64, f32, None, 1e-5),
        ("llama-3.2-vision cross: GQA form, bf16 G=8 D=128 S=1600", 64, 8, 1600, 128, bf16,
         None, 1e-2),
        ("llama-3.2-vision+w4a8 cross: GQA form, int8+bf16 scales S=1600", 64, 8, 1600, 128,
         bf16, bf16, 1e-2),
        ("GQA form, int8+bf16 scales G=8 D=128 S=1500 (scales in place)", 64, 8, 1500, 128,
         bf16, bf16, 1e-2),
    ]
    b, e = 8, 16
    entries = torch.tensor([9, 3, 15, 8, 0, 3, 12, 6], dtype=torch.int32, device="cuda")
    for name, hq, hkv, s, d, dt, sc_dt, atol in cases:
        q, k, v, _, kw = _swiftkv_inputs(torch, gen, e, hq, hkv, s, d, dt,
                                         int8=sc_dt is not None, lengths=[s] * e,
                                         scale_dtype=sc_dt)
        q = q[:b].contiguous()
        src_len = torch.randint(1, s + 1, (e,), generator=gen, device="cuda",
                                dtype=torch.int32)
        src_len[0], src_len[9], src_len[15] = 0, s, 1     # rows 4 (length 0), 0, 2
        lengths = src_len[entries.long()]
        idx = entries.long()
        gathered = {n: x[idx].contiguous() for n, x in kw.items()}
        kg, vg = k[idx].contiguous(), v[idx].contiguous()
        form, own, model_fn = _skv_plan(torch, q, k, None, kw.get("k_scale"))
        want = skv_ref.swiftkv_decode_ref(q, k, v, lengths, entries=entries, **kw).float()
        errs = []
        for n_split in (1, 2, 3, 8, None):
            ns = n_split or own
            out = skv_ops.launch(q, k, v, lengths, n_split=n_split, entries=entries, **kw)
            per_row = skv_ops.launch(q, kg, vg, lengths, n_split=n_split, **gathered)
            torch.cuda.synchronize()
            model = model_fn(q, k, v, lengths, n_split=ns, entries=entries, **kw).float()
            err = max((out.float() - want).abs().max().item(),
                      (out.float() - model).abs().max().item())
            errs.append(f"{ns}{'' if n_split else ' (own)'}: {err:.3g}")
            if not (torch.equal(out, per_row) and torch.isfinite(out).all().item()
                    and err <= atol and (out[4] == 0).all().item()):
                raise AssertionError(f"swiftkv_decode pooled {name} n_split={ns}: not bitwise "
                                     f"the gathered copy's read, err {err} > {atol}, or the "
                                     "length-0 row not exactly 0")
        run = lambda: skv_ops.swiftkv_decode(q, k, v, lengths, entries=entries, **kw)
        first = run()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = run()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(captured, first):
            raise AssertionError(f"swiftkv_decode pooled {name}: replay differs")
        del graph
        log(f"[check] swiftkv_decode pooled {name} ({form} form, E {e} > B {b}, shared and "
            f"length-0 entries): bitwise the read of the gathered copy at every n_split; "
            f"max_abs_err vs oracle and fold model by n_split {{{', '.join(errs)}}} (atol "
            f"{atol:g}); CUDA-graph replay equal")


def _check_exp_lut(torch) -> None:
    """The LUT form's exponential (the kernel's own device function, through
    its elementwise test entry) bit for bit against its plain version
    ``ref.exp_lut_kernel``, on the card and on the CPU: 1,000,001 points on
    [-200, 0], 0 and -0, -1e30 (2^-126: n is clamped), the integers 0 to
    -200, 2,001 points around -87.34 (where 2^n frac turns subnormal and
    is flushed) and a subnormal input."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    x = torch.cat([torch.linspace(-200, 0, 1_000_001, device="cuda"),
                   torch.tensor([0.0, -0.0, -1e30, -1e-40], device="cuda"),
                   -torch.arange(0, 201, device="cuda", dtype=torch.float32),
                   -87.34 + torch.linspace(-0.02, 0.02, 2001, device="cuda")])
    got = skv_ops.exp_lut(x)
    torch.cuda.synchronize()
    bits = lambda t: t.cpu().view(torch.int32)
    on_card = (bits(got) != bits(skv_ref.exp_lut_kernel(x))).sum().item()
    on_cpu = (bits(got) != bits(skv_ref.exp_lut_kernel(x.cpu()))).sum().item()
    flushed = (got[: 1_000_001] == 0).sum().item()
    log(f"[check] exp_lut (the kernel's LUT exponential) on {x.numel()} points: "
        f"{on_card} bitwise mismatches against ref.exp_lut_kernel on the card, {on_cpu} "
        f"against it on the CPU; exp_lut(-1e30) = {got[1_000_003].item():.6g}; "
        f"{flushed} of the grid's points flushed to 0")
    if on_card or on_cpu or got[1_000_003].item() != 2.0 ** -126:
        raise AssertionError("exp_lut: the kernel's LUT exponential differs from its plain "
                             "version")


def _check_swiftkv_lut(torch, gen) -> None:
    """The LUT form (``exp_mode="lut"``), in every form: f32 and bf16 q;
    f32, bf16 and int8 caches; G 1, 4 and 8; D 64, 80 and 128; linear,
    windowed and ring (R 128 and 4224, leg D's); lengths 0, 1 and up to
    3R + 5 in one batch; at n_split 1, 2, 3, 8 and the wrapper's own
    choice. Held to its plain version, the model of the kernel's fold order
    ``swiftkv_decode_split_ref(exp_mode="lut")``, at the native form's
    tolerances (f32 1e-5, bf16 outputs 1e-2): the order matters here, since
    exp(a) exp(b) and exp(a + b) differ by up to the LUT's ~6e-5. Also:
    within 5e-4 of the softmax oracle in f32 (the reference's own bound for
    its LUT kernel); not equal to the native form (the mode is applied); a
    length-0 row exactly 0; the ring form bit for bit the linear LUT form
    on the unrolled cache at every n_split."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    f32, bf16 = torch.float32, torch.bfloat16
    ragged = [0, 1, 31, 32, 256]
    # name, Hq, Hkv, S or R, D, dtype, window, int8 scale dtype, ring, lengths, atol
    cases = [
        ("f32 G=4 D=128 ragged", 8, 2, 256, 128, f32, None, None, False, ragged, 1e-5),
        ("bf16 G=1 D=128 ragged", 4, 4, 256, 128, bf16, None, None, False, ragged, 1e-2),
        ("f32 G=8 D=64 window 100", 64, 8, 256, 64, f32, 100, None, False,
         [256, 200, 77, 1, 0], 1e-5),
        ("int8+bf16 scales G=4 D=80 window 50, f32 q", 32, 8, 256, 80, f32, 50, bf16, False,
         [256, 131, 30, 1, 0], 1e-5),
        ("int8+bf16 scales G=1 D=128, bf16 q", 8, 8, 256, 128, bf16, None, bf16, False,
         ragged, 1e-2),
        ("ring f32 G=4 D=80 R=128 window 100", 32, 8, 128, 80, f32, 100, None, True, None,
         1e-5),
        ("ring bf16 G=8 D=128 R=128 window 64", 64, 8, 128, 128, bf16, 64, None, True, None,
         1e-2),
        ("ring int8+f32 scales G=1 D=64 R=128 window 127, f32 q", 8, 8, 128, 64, f32, 127,
         f32, True, None, 1e-5),
        ("ring f32 G=4 D=80 R=4224 window 4096 (leg D)", 32, 8, 4224, 80, f32, 4096, None,
         True, None, 1e-5),
        ("ring int8+bf16 scales G=4 D=80 R=4224 window 4096, bf16 q (leg D2)", 32, 8, 4224,
         80, bf16, 4096, bf16, True, None, 1e-2),
    ]
    for name, hq, hkv, s, d, dt, win, sc_dt, ring, lens, atol in cases:
        if lens is None:
            lens = [0, 1, win - 1, win + 1, s - 1, s, s + 1, 3 * s + 5]
        q, k, v, lengths, kw = _swiftkv_inputs(torch, gen, len(lens), hq, hkv, s, d, dt,
                                               int8=sc_dt is not None, lengths=lens,
                                               scale_dtype=sc_dt)
        kw.update(window=win, ring=ring)
        oracle = skv_ref.swiftkv_decode_ref(q, k, v, lengths, **kw).float()
        if ring:
            unrolled = {n: skv_ref.unroll_ring(x, lengths, 2) for n, x in kw.items()
                        if n.endswith("scale")}
            ku, vu = (skv_ref.unroll_ring(x, lengths, 1) for x in (k, v))
        errs, worst_oracle, differs = [], 0.0, False
        for n_split in (1, 2, 3, 8, None):
            ns = n_split or skv_ops.split_plan(q, k, win, k_scale=kw.get("k_scale"),
                                               exp_mode="lut")
            out = skv_ops.launch(q, k, v, lengths, n_split=ns, exp_mode="lut", **kw)
            native = skv_ops.launch(q, k, v, lengths, n_split=ns, **kw)
            same_linear = True
            if ring:
                linear = skv_ops.launch(q, ku, vu, lengths, n_split=ns, exp_mode="lut",
                                        window=win, **unrolled)
                same_linear = torch.equal(out, linear)
            torch.cuda.synchronize()
            model = skv_ref.swiftkv_decode_split_ref(q, k, v, lengths, n_split=ns,
                                                     exp_mode="lut", **kw).float()
            err = (out.float() - model).abs().max().item()
            worst_oracle = max(worst_oracle, (out.float() - oracle).abs().max().item())
            differs |= not torch.equal(out, native)
            errs.append(f"{ns}{'' if n_split else ' (own)'}: {err:.3g}")
            if not (torch.isfinite(out).all().item() and err <= atol and same_linear
                    and (out[lengths == 0] == 0).all().item()):
                raise AssertionError(f"swiftkv_decode lut {name} n_split={ns}: err {err} > "
                                     f"{atol}, a length-0 row not exactly 0, or the ring "
                                     f"form not bitwise its linear form ({same_linear})")
        # f32: the reference's bound for its LUT kernel; bf16 outputs: two
        # bf16 steps at |out| < 4 (the port's bf16 tests' bound)
        oracle_tol = 5e-4 if dt == f32 else 3e-2
        log(f"[check] swiftkv_decode lut {name}, lengths {lens}: max_abs_err vs the plain "
            f"model of its fold by n_split {{{', '.join(errs)}}} (atol {atol:g}); vs the "
            f"softmax oracle {worst_oracle:.3g} (tol {oracle_tol:g}); differs from the native "
            f"form {differs}" + ("; bitwise the linear LUT form on the unrolled cache at "
                                 "every n_split" if ring else ""))
        if worst_oracle > oracle_tol or not differs:
            raise AssertionError(f"swiftkv_decode lut {name}: {worst_oracle} off the softmax "
                                 f"oracle (tol {oracle_tol}), or equal to the native form")


def phase_reduced_models(torch) -> None:
    """Reduced models on the card (kernels, f32) against the same models on
    the CPU (plain versions): same weights, greedy tokens equal. The
    h2o-danube-1.8b and hymba-1.5b configs (window 32) take a 150-token
    prompt with max_len 256: the ring has 128 slots, so the prefill wraps
    it."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models.api import build_model
    from repro_torch.serving import ServingEngine
    for arch, prompt_len, max_len in (("llama2-7b", 16, 64), ("qwen3-8b+w4a8", 16, 64),
                                      ("h2o-danube-1.8b", 150, 256),
                                      ("h2o-danube-1.8b+ring", 150, 256),
                                      ("h2o-danube-1.8b+ring+w4a8", 150, 256),
                                      ("chatglm-6b+w4a8", 16, 64), ("gemma-2b", 16, 64),
                                      ("mistral-nemo-12b", 16, 64), ("olmoe-1b-7b", 16, 64),
                                      ("llama4-scout-17b-a16e+w4a8", 16, 64),
                                      ("rwkv6-3b", 16, 64), ("rwkv6-3b+w4a8", 16, 64),
                                      ("hymba-1.5b", 150, 256), ("hymba-1.5b+ring", 150, 256),
                                      ("hymba-1.5b+ring+w4a8", 150, 256)):
        cfg = get_config(arch, reduced=True).replace(decode_impl="kernel")
        cpu = build_model(cfg, device="cpu")
        params = cpu.init_params(0)
        gpu = build_model(cfg, device="cuda")
        params_gpu = _tree_to(params, "cuda")
        prompts = torch.randint(0, cfg.vocab_size, (4, prompt_len),
                                generator=torch.Generator().manual_seed(3))
        want = ServingEngine(cpu, params, max_len=max_len, batch=4).generate(prompts,
                                                                             steps=16)
        got = ServingEngine(gpu, params_gpu, max_len=max_len, batch=4).generate(prompts,
                                                                                steps=16)
        same = (got.cpu() == want).float().mean().item()
        log(f"[check] reduced {arch} (prompt {prompt_len}, max_len {max_len}): card vs CPU "
            f"greedy token agreement {same:.4f}")
        if same != 1.0:
            raise AssertionError(f"reduced {arch}: card tokens differ from the CPU's")
        if arch == "llama2-7b":       # sampled, on the reference's key stream
            key = prng.prng_key(0)
            want = ServingEngine(cpu, params, max_len=max_len, batch=4).generate(
                prompts, steps=16, temperature=0.8, rng=key)
            got = ServingEngine(gpu, params_gpu, max_len=max_len, batch=4).generate(
                prompts, steps=16, temperature=0.8, rng=key)
            same = (got.cpu() == want).float().mean().item()
            log(f"[check] reduced {arch}: card vs CPU sampled token agreement (temperature "
                f"0.8, key prng_key(0)) {same:.4f}")
            if same != 1.0:
                raise AssertionError(f"reduced {arch}: card sampled tokens differ from the "
                                     "CPU's")
    _reduced_xattn(torch)


XATTN_GATE = 0.5    # every cross gate of the cross-attention legs (0 at init)


def _with_gates(tree, value):
    """``tree`` with every cross-attention gate (the rank-1 ``gate``
    leaves; a gated MLP's ``gate`` is a matrix) set to ``value``: at the
    reference's init of 0 the cross terms would vanish."""
    return {k: _with_gates(v, value) if isinstance(v, dict)
            else v.new_full(v.shape, value) if k == "gate" and v.dim() <= 1 else v
            for k, v in tree.items()}


def _reduced_xattn(torch) -> None:
    """The reduced cross-attention configs on the card (kernels, f32)
    against the same models on the CPU, every gate 0.5: lock-step greedy
    tokens with sources of 24, 10, 17 and 0 rows (per-row cross reads),
    then the continuous engine's over a trace with sources shared by pairs
    (the pooled reads, ``entries=``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, poisson_trace
    for arch in ("whisper-small", "whisper-small+w4a8", "llama-3.2-vision-90b",
                 "llama-3.2-vision-90b+w4a8"):
        cfg = get_config(arch, reduced=True).replace(decode_impl="kernel")
        cpu = build_model(cfg, device="cpu")
        params = _with_gates(cpu.init_params(0), XATTN_GATE)
        gpu = build_model(cfg, device="cuda")
        params_gpu = _tree_to(params, "cuda")
        g = torch.Generator().manual_seed(3)
        prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
        src = torch.randn((4, cfg.source_len, cfg.d_model), generator=g)
        lens = torch.tensor([cfg.source_len, 10, 17, 0], dtype=torch.int32)
        runs = []
        for model, p in ((cpu, params), (gpu, params_gpu)):
            eng = ServingEngine(model, p, max_len=64, batch=4, source_len=cfg.source_len)
            runs.append(eng.generate(prompts, steps=16, source=src, source_len=lens).cpu())
        same = (runs[0] == runs[1]).float().mean().item()
        trace_kw = dict(n_requests=6, vocab_size=cfg.vocab_size, prompt_len=(3, 18),
                        max_new=(3, 12), seed=5, source_len=(6, cfg.source_len),
                        source_dim=cfg.d_model, source_share=2)
        cont = []
        for model, p in ((cpu, params), (gpu, params_gpu)):
            eng = ContinuousBatchingEngine(model, p, n_slots=2, max_len=64, chunk=8,
                                           decode_ticks=4)
            cont.append({r["rid"]: r["tokens"]
                         for r in eng.run(poisson_trace(**trace_kw))["requests"]})
        log(f"[check] reduced {arch} (gates {XATTN_GATE}): card vs CPU lock-step greedy token "
            f"agreement {same:.4f} (sources of {lens.tolist()} rows); continuous tokens equal "
            f"{cont[0] == cont[1]} (6 requests, sources shared by pairs)")
        if same != 1.0 or cont[0] != cont[1]:
            raise AssertionError(f"reduced {arch}: card tokens differ from the CPU's")


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _takes_mma(torch, cfg) -> bool:
    """Whether a config's decode attention takes the GQA form on tensor
    cores (``ops.kernel_form`` of its heads, head dim and dtypes)."""
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops
    dtype = getattr(torch, cfg.compute_dtype)
    return skv_ops.kernel_form(cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                               torch.int8 if cfg.w4a8_serve else dtype) == "mma"


def _w4a8_projections(cfg) -> int:
    """W4A8 projections per layer: wq, wk, wv, wo, and the MLP's up, down
    and (gated) gate; an MoE layer's experts stay dense, and so do a hybrid
    layer's Mamba projections. RWKV6: wk, wv and wo (wr, wg and the channel
    mix stay dense)."""
    if cfg.family == "ssm":
        return 3
    return 4 + (0 if cfg.n_experts else 2 + cfg.gated_mlp)


def _expect(**counts) -> dict:
    """Expected launch counts of a run: ``counts``, and 0 for every other
    kernel the wrapper counts."""
    from repro_torch.kernels import LAUNCHES
    return {name: counts.get(name, 0) for name in LAUNCHES}


def _serve_leg(torch, label, model, params, *, prompt_len, steps, expect, plain_model,
               rel_tols, mem_bps, breakdown, src=None):
    """Drive ``ServingEngine.generate`` (the main path) once with the launch
    counts zeroed, then compare a prefill and a decode step with the plain
    path on the same weights and cache. ``rel_tols`` maps each dtype to the
    limit of that comparison (see ``_compare_paths``). ``src``: a
    cross-attention model's (sources [8, S_src, d], lengths [8]), passed to
    every prefill; the leg then also holds each layer's cross read alone
    against the dense oracle (``_cross_read_check``)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine
    cfg = model.cfg
    t_leg = time.perf_counter()
    batch = 8
    eng = ServingEngine(model, params, max_len=prompt_len + steps, batch=batch,
                        source_len=None if src is None else src[0].shape[1])
    gen_kw = {} if src is None else {"source": src[0], "source_len": src[1]}
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    eng.generate(prompts, steps=2, **gen_kw)                    # warmup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, steps=0, **gen_kw).cpu()              # prefill + first pick
    prefill_s = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=steps, **gen_kw).cpu()
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
                   rel_tols, src)
    if src is not None:
        _cross_read_check(torch, label, model, eng.params, prompts, prompt_len + steps, src)
    if breakdown:
        _step_breakdown(torch, label, model, eng.params, prompts, prompt_len + steps, mem_bps,
                        src=src)
    log(f"[{label}] leg took {time.perf_counter() - t_leg:.1f} s")
    return {"prefill_ms": 1e3 * prefill_s, "decode_ms_per_step": decode_ms,
            "tokens_per_s": batch * steps / wall, "launches": counts, "prompts": prompts,
            "tokens": out}


LEG_F = {"batch": 8, "prompt_len": 64, "max_len": 128, "steps": 16}


def _tokenwise_leg(torch, kernel_model, params, setup=LEG_F) -> dict:
    """Leg F: the paper-literal decode path, ``decode_impl="tokenwise"``
    (plain PyTorch, one step of Eqs. 6/7 per cache slot), at published
    width on leg A's weights: ``ServingEngine.generate``, batch 8, prompt
    64, max_len 128, 16 greedy steps, with the launch counts zeroed: no
    kernel may launch (tokenwise attention is plain PyTorch, the config has
    no W4A8). Then the same prompts teacher-forced on the kernel path's
    greedy tokens, every step's logits against the kernel path's: max
    |difference| over max |logit| within 0.10 (leg A's bf16 limit: the
    paths differ in summation order and exponential, and bf16 roundings
    that one ulp can move compound over 32 layers), and every step whose
    argmax differs a near-tie: the kernel path's top-2 gap no more than
    twice that row's max |logit difference| there. So the served tokens
    equal the kernel path's up to each row's first near-tie."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.api import build_model
    from repro_torch.serving import ServingEngine
    t_leg = time.perf_counter()
    model = build_model(kernel_model.cfg.replace(decode_impl="tokenwise"))
    b, plen, max_len, steps = (setup[k] for k in ("batch", "prompt_len", "max_len", "steps"))
    prompts = torch.randint(0, model.cfg.vocab_size, (b, plen), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(5))
    eng = ServingEngine(model, params, max_len=max_len, batch=b)
    eng.generate(prompts, steps=1)                               # warmup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, steps=0).cpu()
    prefill_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=steps).cpu()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    step_ms = 1e3 * (wall - prefill_s) / steps
    log(f"[legF] {model.cfg.name} decode_impl=tokenwise: batch {b}, prompt {plen}, max_len "
        f"{max_len} ({max_len} slots scanned per layer per step), {steps} greedy steps; "
        f"prefill {1e3 * prefill_s:.1f} ms, eager decode {step_ms:.2f} ms/step; launches "
        f"on the serving path: {counts}")
    if counts != _expect():
        raise AssertionError(f"legF: a kernel launched on the tokenwise path: {counts}")

    def run(m, tokens=None):
        with torch.inference_mode():
            cache = m.init_cache(b, max_len)
            logits, cache = m.prefill(params, prompts, cache)
            outs = [logits]
            for i in range(steps):
                tok = logits.argmax(-1).to(torch.int32) if tokens is None else tokens[:, i]
                logits, cache = m.decode_step(params, tok, cache)
                outs.append(logits)
            del cache
        return torch.stack(outs[:steps]).float()                 # [steps, B, V]

    kern = run(kernel_model)
    toks = kern.argmax(-1).to(torch.int32).T.contiguous()        # [B, steps]
    tokw = run(model, toks)
    diff = (tokw - kern).abs().amax(-1)                          # [steps, B]
    rel = diff.max().item() / kern.abs().max().item()
    top2 = kern.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flips = tokw.argmax(-1) != kern.argmax(-1)
    unexplained = (flips & (gap > 2 * diff)).sum().item()
    firsts = []
    for row in range(b):
        differ = (out[row] != toks[row].cpu()).nonzero()
        j = int(differ[0]) if len(differ) else None
        firsts.append("-" if j is None else
                      f"{j} (top-2 gap {gap[j, row].item():.4f}, |dlogit| {diff[j, row].item():.4f})")
    agree = (out == toks.cpu()).float().mean().item()
    log(f"[legF] teacher-forced on the kernel path's tokens: max |logit difference| "
        f"{diff.max().item():.4g} of max |logit| {kern.abs().max().item():.4g} = {rel:.4f} "
        f"(limit 0.10); argmax flips {flips.sum().item()} of {flips.numel()}, "
        f"{unexplained} not at a near-tie; served tokens vs the kernel path's: agreement "
        f"{agree:.4f}, first divergence by row: {'; '.join(firsts)}; leg took "
        f"{time.perf_counter() - t_leg:.1f} s")
    if not (torch.isfinite(tokw).all().item() and rel <= 0.10 and not unexplained):
        raise AssertionError(f"legF: tokenwise logits off the kernel path's ({rel:.4f}) or "
                             f"{unexplained} token flips away from a near-tie")
    return {"decode_ms_per_step": step_ms, "prefill_ms": 1e3 * prefill_s,
            "launches": counts, "rel_logit_diff": rel, "token_agreement": agree}


EXPERT_KEYS = ("blocks/ffn/up", "blocks/ffn/gate", "blocks/ffn/down")


RECURRENT_STATE = ("rwkv_att", "rwkv_ffn", "rwkv_wkv", "mamba_conv", "mamba_ssm")


def _step_bytes(params, cache, batch: int, window: int | None = None,
                experts: list[int] | None = None) -> tuple[int, int]:
    """Bytes one decode step must move: every weight once (the embedding
    only at the batch's rows, unless it is also the unembedding), the KV
    cache up to each row's length, or its last ``window`` positions, and
    the recurrent state planes (RWKV6's, Mamba's) read once and written
    once. On an MoE model ``experts`` gives the distinct experts the step's
    router picked, layer by layer: only those experts' matrices are read.
    A cross-attention model's decode reads its per-row source K/V up to
    each row's ``source_len`` and none of the cross layers' wk / wv (the
    source's K/V are cached); an encoder-decoder's ``params`` are its
    decoder's. Returns (weight bytes, cache and state bytes)."""
    moe = experts is not None
    cached = lambda k: "cross/wk" in k or "cross/wv" in k
    weights = sum(t.numel() * t.element_size() for k, t in _items(params)
                  if k != "embed" and not (moe and k in EXPERT_KEYS) and not cached(k))
    embed = params["embed"]
    weights += (embed.numel() if "unembed" not in params else batch * embed.shape[1]) \
        * embed.element_size()
    if moe:
        stacks = [t for k, t in _items(params) if k in EXPERT_KEYS]    # [L, E, ...]
        per_expert = sum(t[0, 0].numel() * t.element_size() for t in stacks)
        weights += per_expert * sum(experts)
    kv = sum(2 * cache[k].numel() * cache[k].element_size() for k in RECURRENT_STATE
             if k in cache)
    if "cross_k" in cache:          # [Lc, B, S_src, Hkv, Dh], each row to its source_len
        ck = cache["cross_k"]
        row = ck.shape[0] * ck.shape[3] * ck.shape[4] * ck.element_size()
        kv += 2 * row * int(cache["source_len"].sum())
    if "k" not in cache:
        return weights, kv
    length = min(int(cache["len"].max()) + 1, window or cache["k"].shape[2])
    for key, pos_axis in (("k", 2), ("v", 2), ("k_scale", 3), ("v_scale", 3)):
        if key in cache:            # [L, B, S, Hkv, Dh] rows, [L, B, Hkv, S] scales
            t = cache[key]
            kv += t.numel() * t.element_size() * length // t.shape[pos_axis]
    return weights, kv


@contextlib.contextmanager
def _expert_picks(torch):
    """Inside the block, each rowwise MoE call (one a layer of a decode
    step) appends the number of distinct experts its router picks."""
    from repro_torch.models import moe
    picks, rowwise = [], moe.moe_apply_rowwise

    def recording(p, x, **kw):
        picks.append(int(moe._route(x, p["router"], kw["top_k"])[0].unique().numel()))
        return rowwise(p, x, **kw)
    with _swapped(moe, "moe_apply_rowwise", recording):
        yield picks


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _step_breakdown(torch, label, model, params, prompts, max_len, mem_bps, n_steps=8,
                    src=None):
    """Where one decode step's time goes, after a prefill (``--breakdown``,
    and always on the cross-attention lock-step legs): the eager step (host
    clock, synchronized), the same step replayed from a CUDA graph (device
    work with no host gaps), and the profiler's device time by kernel over
    eager steps. ``src``: as ``_serve_leg``'s."""
    from torch.profiler import ProfilerActivity, profile
    batch = prompts.shape[0]
    with torch.inference_mode():
        if src is None:
            cache = model.init_cache(batch, max_len)
            logits, cache = model.prefill(params, prompts, cache)
        else:
            cache = model.init_cache(batch, max_len, src[0].shape[1])
            logits, cache = model.prefill(params, prompts, cache, *src)
        tok = logits.argmax(-1).to(torch.int32)
        with _expert_picks(torch) as picks:
            model.decode_step(params, tok, cache)
        w_bytes, kv_bytes = _step_bytes(params.get("decoder", params), cache, batch,
                                        model.cfg.window,
                                        picks if model.cfg.n_experts else None)
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
    log(f"[{label}] decode-step bound: weights {w_bytes / 1e9:.3f} GB + KV cache and "
        f"recurrent state {kv_bytes / 1e9:.3f} GB -> {bound_ms:.3f} ms at "
        f"{mem_bps / 1e12:.2f} TB/s"
        + (f" (experts read, distinct picks by layer: {picks})" if model.cfg.n_experts
           else ""))
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
BF16_NOISE = 2.0 ** -8  # relative attention noise of a bf16 witness (one rounding)
PER_CALL_TOL = 1e-5     # f32 kernel call vs plain version, of max |output|


def _noisy(torch, plain, gen, noise=NOISE):
    """``plain`` with each output multiplied by (1 + noise * N(0, 1))."""
    def call(*args, **kw):
        out = plain(*args, **kw)
        return out * (1 + noise * torch.randn(out.shape, generator=gen,
                                              device=out.device)).to(out.dtype)
    return call


def _compare_paths(torch, label, model, plain_model, params, prompts, max_len, rel_tols,
                   src=None):
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
    (on an H100 the kernel path's difference came to 0.9-1.0 times it). A
    config with no W4A8 projection (an MoE leg) moves every decode
    attention output instead, by BF16_NOISE in bf16 (one rounding, where
    the kernel's bf16 output may differ from the plain version's) and NOISE
    in float32: on an MoE model such a move can change a near-tied
    router's top-k, and the witness shows what that does to the logits.
    ``src``: a cross-attention model's (sources, lengths), given to every
    prefill (the per-row cross reads are kernel calls too)."""
    from repro_torch.core import attention as attn_lib
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    from repro_torch.models.api import build_model
    batch = prompts.shape[0]
    src_rows = None if src is None else src[0].shape[1]
    src = () if src is None else src
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
            cache = kern.init_cache(batch, max_len, src_rows)
            logits_k, cache = kern.prefill(params, prompts, cache, *src)
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

        def plain_run(gemv, attention=attn_lib.decode_attention):
            with (torch.inference_mode(), _swapped(gemv_ops, "gemv_w4a8", gemv),
                  _swapped(attn_lib, "decode_attention", attention)):
                logits, _ = plain.prefill(params, prompts,
                                          plain.init_cache(batch, max_len, src_rows), *src)
                step, _ = plain.decode_step(params, tok,
                                            {k: v.clone() for k, v in snapshot.items()})
            return logits, step

        plain_out = plain_run(gemv_ref.gemv_w4a8_ref)
        witness = []
        quantized = plain.cfg.w4a8_serve
        moved = ("GEMV outputs" if quantized else "decode attention outputs") + " moved by " \
            + f"{NOISE if quantized or dtype == 'float32' else BF16_NOISE:.3g}"
        if rel_tol is None:
            for seed in (0, 1):
                gen = torch.Generator(device=prompts.device).manual_seed(seed)
                if quantized:
                    witness.append(plain_run(_noisy(torch, gemv_ref.gemv_w4a8_ref, gen)))
                else:
                    noise = NOISE if dtype == "float32" else BF16_NOISE
                    witness.append(plain_run(gemv_ref.gemv_w4a8_ref, _noisy(
                        torch, attn_lib.decode_attention, gen, noise)))
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
                       f"{moved}; its argmax agreement {w_agree:.3f})")
            else:
                limit = rel_tol * scale
                how = f"tol {rel_tol:g} x"
            log(f"[{label}] {what} logits in {dtype}, kernel vs plain path: max_abs_err "
                f"{err:.4g} of max |logit| {scale:.4g}, argmax agreement {agree:.3f}; {how}")
            if not (torch.isfinite(a).all().item() and err <= limit):
                raise AssertionError(f"{label} {what} ({dtype}): kernel path off the "
                                     f"plain path by {err} > {limit}")


def _cross_read_check(torch, label, model, params, prompts, max_len, src) -> None:
    """Each cross layer's read alone, before its gate: the kernel on the
    per-row source K/V that a prefill wrote, for a bf16 query, against the
    dense oracle (``decode_attention(impl="naive")``) on the same inputs;
    the worst max |difference| over the layers as a fraction of max
    |output|, limit 2^-7 (two bf16 roundings)."""
    from repro_torch.core import attention as attn_lib
    from repro_torch.kernels import LAUNCHES
    cfg = model.cfg
    with torch.inference_mode():
        cache = model.init_cache(prompts.shape[0], max_len, src[0].shape[1])
        model.prefill(params, prompts, cache, *src)
        q = torch.randn((prompts.shape[0], cfg.n_heads, cfg.resolved_head_dim), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5)
                        ).to(cache["cross_k"].dtype)
        worst, before = 0.0, dict(LAUNCHES)
        for j in range(cache["cross_k"].shape[0]):
            args = (q, cache["cross_k"][j], cache["cross_v"][j], cache["source_len"])
            got = attn_lib.decode_attention(*args, impl="kernel").float()
            want = attn_lib.decode_attention(*args, impl="naive").float()
            scale = want.abs().max().item()
            if not scale > 0:
                raise AssertionError(f"{label}: cross read of layer {j} is all zero")
            worst = max(worst, (got - want).abs().max().item() / scale)
        LAUNCHES.update(before)           # comparison launches are not the path's
    log(f"[{label}] cross read alone (per-row, before the gate), kernel vs dense oracle over "
        f"{cache['cross_k'].shape[0]} layers, source lengths {src[1].tolist()}: worst "
        f"max_abs_err {worst:.3g} of max |out| (limit {2 ** -7:.3g}; last layer's max |out| "
        f"{scale:.3g})")
    if worst > 2 ** -7:
        raise AssertionError(f"{label}: a cross read is off the oracle by {worst:.3g}")


def _breakdown_only(torch, label, model, params, prompt_len, steps, mem_bps,
                    src=None) -> None:
    """``--breakdown-only``: one timed prefill and the decode-step
    breakdown of a leg, with no serving run and no check (it uses only the
    model API, so it also runs on an older tree of the port for a
    before/after on one card). The prefill: host clock around a
    synchronized ``model.prefill`` of batch 8, after one warm-up, the
    median of 5."""
    prompts = torch.randint(0, model.cfg.vocab_size, (8, prompt_len), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    times = []
    src_rows = None if src is None else src[0].shape[1]
    with torch.inference_mode():
        for _ in range(6):
            cache = model.init_cache(8, prompt_len + steps, src_rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, prompts, cache, *(src or ()))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            del cache
    log(f"[{label}] prefill of 8 x {prompt_len} tokens (model.prefill, synchronized): median "
        f"{statistics.median(times[1:]):.2f} ms of 5 (runs {', '.join(f'{t:.2f}' for t in times[1:])})")
    _step_breakdown(torch, label, model, params, prompts, prompt_len + steps, mem_bps,
                    src=src)


LEG_C = {"n_slots": 8, "max_len": 1024, "chunk": 128, "decode_ticks": 8}
LEG_C_TRACE = {"n_requests": 16, "prompt_len": (64, 512), "max_new": (16, 64), "seed": 7}
# leg E: every prompt is near or past the 4224-slot ring (round128(4096 + 128))
LEG_E = {"n_slots": 4, "max_len": 6144, "chunk": 128, "decode_ticks": 8}
LEG_E_TRACE = {"n_requests": 8, "prompt_len": (3968, 5120), "max_new": (16, 96), "seed": 7}


def _continuous_leg(torch, label, model, params, setup=LEG_C, trace_kw=LEG_C_TRACE,
                    n_solo=3, horizon=True, keep=False):
    """Leg C (and E): ``ContinuousBatchingEngine`` (the continuous main
    path) with ``setup`` over a backlogged ``poisson_trace(**trace_kw)`` at
    full width, greedy, with its checks, each raising: (1) every request
    retires with its full budget and every slot is free at the end; (2) the
    launch counts of the run equal the engine's own counters (one decode
    attention per layer and tick issued — the ring form on a ring config —
    on +w4a8 one decode-form GEMV per projection, layer and tick and one
    prefill-form quantize + GEMM launch per projection, layer and prefill
    chunk: ``_w4a8_projections``); (3)
    ``n_solo`` of the requests, each run alone through an engine of the
    same shape, get bitwise their tokens of the full run; (4, with
    ``horizon``) four requests get bitwise the same tokens at decode_ticks
    1 and 8; (5) one decode_multi block of K = 8 (greedy, then sampled)
    runs under ``torch.cuda.set_sync_debug_mode("error")``; (6) the first
    ``AGREE_REQUESTS`` requests' token agreement with lock-step
    ``ServingEngine(batch=1).generate`` and the first divergence with the
    lock-step top-2 logit gap there, printed, not asserted (chunked prefill re-reads the prefix
    through the cache, on +w4a8 through int8). On a ring config also: a
    slot taken over from an occupant that wrapped the ring (asserted), and
    the ring's rows and bytes per slot beside the linear twin's. Returns the
    run's launches, aggregate and tokens (and, with ``keep``, its engine)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ContinuousBatchingEngine, poisson_trace
    cfg = model.cfg
    ring = bool(cfg.kv_ring and cfg.window)
    t_leg = time.perf_counter()

    def engine(**kw):
        return ContinuousBatchingEngine(model, params, **{**setup, **kw})

    trace = poisson_trace(vocab_size=cfg.vocab_size, rate=None, **trace_kw)
    eng = engine().warmup()
    occupants = []                      # (slot, rid) in admission order
    alloc = eng.pool.alloc

    def recording_alloc(rid):
        slot = alloc(rid)
        occupants.append((slot, rid))
        return slot
    eng.pool.alloc = recording_alloc
    torch.cuda.synchronize()
    reset_launches()
    report = eng.run(trace)
    counts = dict(LAUNCHES)
    agg = report["aggregate"]
    got = {r["rid"]: r["tokens"] for r in report["requests"]}
    log(f"[{label}] {cfg.name} continuous, {setup} over poisson_trace({trace_kw}): "
        f"{agg['n_retired']} requests, {agg['generated_tokens']} tokens in {agg['wall_s']} s = "
        f"{agg['tokens_per_s']} tokens/s; TTFT p50 {agg['ttft_p50_s']} s, p99 "
        f"{agg['ttft_p99_s']} s; ITL p50 {agg['itl_p50_ms']} ms ({agg['itl_source']}), effective "
        f"{agg['itl_effective_ms']} ms/token; dispatches_per_token {agg['dispatches_per_token']}, "
        f"host_syncs {agg['host_syncs']}, parked_ticks {agg['parked_ticks']}, "
        f"kv_bytes_per_slot {agg['kv_bytes_per_slot']}"
        + (f"; source_ingests {agg['source_ingests']}, source_shares {agg['source_shares']}"
           if "source_ingests" in agg else ""))
    log(f"[{label}] engine counters: {agg['decode_dispatches']} decode blocks, "
        f"{agg['decode_ticks_run']} ticks, {agg['prefill_chunks']} prefill chunks in "
        f"{agg['prefill_dispatches']} batched calls, mean occupancy {agg['mean_occupancy']}; "
        f"launches {_nonzero(counts)}")

    # (1) every request retires with its full budget (no EOS), no slot leaks
    budgets = {r.rid: r.max_new_tokens for r in trace}
    if (agg["n_retired"] != len(trace) or eng.pool.n_free != setup["n_slots"]
            or any(len(got[rid]) != n for rid, n in budgets.items())
            or any(not 0 <= t < cfg.vocab_size for toks in got.values() for t in toks)):
        raise AssertionError(f"{label}: requests did not all retire with their budgets")
    # (2) launch counts against the engine's own counters
    ticks, chunks = agg["decode_ticks_run"], agg["prefill_chunks"]
    expect = _continuous_expect(torch, model, ticks, chunks, agg.get("source_ingests", 0))
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != expected {expect}")
    log(f"[{label}] check 1: all {len(trace)} requests retired with their budgets, "
        f"{eng.pool.n_free} slots free; check 2: launches equal the engine counters' {expect}")
    if ring:
        _ring_reuse(label, eng, trace, occupants, setup)
    eng.pool.alloc = alloc
    kept = {"engine": eng} if keep else {}
    del eng

    # (3) batch composition: requests, each alone
    solo = engine()
    for r in trace[:n_solo]:
        alone = solo.run([r])["requests"][0]["tokens"]
        if alone != got[r.rid]:
            raise AssertionError(f"{label}: request {r.rid} alone differs from its tokens "
                                 f"in the full run")
    del solo
    log(f"[{label}] check 3: requests {[r.rid for r in trace[:n_solo]]} alone bitwise equal "
        f"to the full run")
    # (4) tick horizon: four requests at decode_ticks 1 and 8
    if horizon:
        runs = {}
        for ticks in (1, 8):
            e = engine(decode_ticks=ticks)
            runs[ticks] = {r["rid"]: r["tokens"] for r in e.run(trace[:4])["requests"]}
            del e
        if runs[1] != runs[8]:
            raise AssertionError(f"{label}: tokens differ between decode_ticks 1 and 8")
        log(f"[{label}] check 4: requests {[r.rid for r in trace[:4]]} bitwise equal at "
            f"decode_ticks 1 and 8")

    # (5) no host synchronization inside a decode_multi block, and what a
    # chunk and a tick cost alone
    _sync_free_block(torch, label, model, params, trace, setup)

    # (6) agreement with lock-step, measured, not asserted
    _lockstep_agreement(torch, label, model, params, trace, got, setup["max_len"])
    log(f"[{label}] leg took {time.perf_counter() - t_leg:.1f} s")
    return {"launches": counts, "aggregate": agg, "tokens": got, **kept}


# ---- the serving extras: telemetry, faults, cancel, drain, the auditor ----

def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _outcome(report) -> dict:
    """rid -> (status, code, tokens) of every request in a report."""
    return {r["rid"]: (r["status"], r["code"], r["tokens"]) for r in report["requests"]}


def _counted_run(torch, label, eng, trace, step_hook=None):
    """``eng.run(trace)`` with the launch counts set to 0 just before and read
    just after, held against the engine's counters (``_continuous_expect``).
    ``step_hook(n)`` is called before the engine's n-th step (cancel, drain).
    Returns the report and the counts."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    if step_hook is not None:
        step, n = eng.step, [0]

        def hooked(*args, **kw):
            n[0] += 1
            step_hook(n[0])
            return step(*args, **kw)
        eng.step = hooked
    try:
        torch.cuda.synchronize()
        reset_launches()
        report = eng.run(trace)
        counts = dict(LAUNCHES)
    finally:
        if step_hook is not None:
            del eng.step
    agg = report["aggregate"]
    expect = _continuous_expect(torch, eng.model, agg["decode_ticks_run"], agg["prefill_chunks"],
                                agg.get("source_ingests", 0))
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != expected {expect}")
    return report, counts


def _recovered(label, eng, outcome, clean, errored=(), partial=()) -> None:
    """The recovery contract: the ``errored`` requests ended errored, the
    ``partial`` ones with a prefix of their clean tokens, every other
    retired request with exactly its clean tokens; no slot or source entry
    held, the ledgers conserved."""
    for rid, (status, code, toks) in outcome.items():
        if rid in errored:
            ok = status == "errored" and toks == clean[rid][:len(toks)]
        elif rid in partial:
            ok = status == "retired" and toks == clean[rid][:len(toks)]
        else:
            ok = status != "retired" or toks == clean[rid]
        if not ok:
            raise AssertionError(f"{label}: request {rid} ended {status} ({code}) with "
                                 f"{len(toks)} tokens against its clean run's")
    eng.sched.assert_conservation()
    if eng.pool.n_used or (eng.src_pool is not None and eng.src_pool.n_used):
        raise AssertionError(f"{label}: slots or source entries still held after the run")


def _extras_legs(torch, model, params, leg_c1) -> dict:
    """Legs T1 and T2, the serving extras at leg C1's width, on C1's model and
    weights (no model is loaded again), leg C's setup and trace. T1: an engine
    with ``telemetry=Telemetry(jsonl_path=...)`` and ``auditor=EngineAuditor()``;
    its tokens bitwise C1's untraced run, the event counts equal to the
    report's counters, the JSONL reloaded, the Chrome trace written and
    parsed back, ``audit_checks`` > 0; then one run with telemetry alone, and
    tokens/s beside C1's. T2: T1's engine under a ``FaultPlan`` (a
    ``poison_nan`` victim at block 2, a ``tick_delay``, a ``dispatch_fail``):
    the victim errored ``nonfinite_logits``, every bystander bitwise C1's,
    no slot held, ``plan.replay()`` the same report; then a run that cancels
    an in-flight request at its 4th step and one that drains at its 4th step,
    each held to the recovery contract. Every run is launch-counted."""
    from repro_torch.serving import (ContinuousBatchingEngine, EngineAuditor, Fault,
                                     FaultPlan, Telemetry, chrome_trace, load_events_jsonl,
                                     poisson_trace)
    t_leg = time.perf_counter()
    out = ROOT / "build" / "serving_extras"
    out.mkdir(parents=True, exist_ok=True)
    clean, c1 = leg_c1["tokens"], leg_c1["aggregate"]

    def trace():
        return poisson_trace(vocab_size=model.cfg.vocab_size, rate=None, **LEG_C_TRACE)

    tel = Telemetry(jsonl_path=out / "legT1.events.jsonl")
    eng = ContinuousBatchingEngine(model, params, telemetry=tel, auditor=EngineAuditor(),
                                   **LEG_C).warmup()
    # the hooks' own host time: every event passes through emit, the gauges
    # are sampled once a block (their emit inside), audits once a block
    spent = dict.fromkeys(("emit", "gauges", "audit"), 0.0)

    def timed(name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return call
    tel.emit = timed("emit", tel.emit)
    eng._sample_gauges = timed("gauges", eng._sample_gauges)
    eng.auditor.check = timed("audit", eng.auditor.check)
    report, counts = _counted_run(torch, "legT1", eng, trace())
    hooks = {k: round(1e3 * v, 3) for k, v in spent.items()}
    agg = report["aggregate"]
    if {rid: toks for rid, (_, _, toks) in _outcome(report).items()} != clean:
        raise AssertionError("legT1: traced tokens differ from leg C1's untraced run")
    n, c = agg["n_retired"], tel.counts()
    want = {"enqueue": n, "admit": n, "first_token": n, "release": n,
            "decode_block": agg["decode_dispatches"], "gauges": agg["decode_dispatches"],
            "prefill_chunk": agg["prefill_chunks"]}
    if ({k: c[k] for k in want} != want or c["eos"] + c["budget_retire"] != n
            or agg["telemetry_events"] != len(tel.events) or agg["audit_checks"] < 1):
        raise AssertionError(f"legT1: event counts {dict(c)} against the report {agg}")
    tel.flush()
    if [e.to_json() for e in load_events_jsonl(out / "legT1.events.jsonl")] != \
            [e.to_json() for e in tel.events]:
        raise AssertionError("legT1: the JSONL stream does not reload to the events")
    doc = json.loads(tel.write_chrome_trace(out / "legT1.trace.json").read_text())
    if doc != json.loads(json.dumps(chrome_trace(tel.events))) or not doc["traceEvents"]:
        raise AssertionError("legT1: the Chrome trace does not parse back")
    eng.auditor = None
    spent.update(dict.fromkeys(spent, 0.0))
    report = eng.run(trace())
    tel_only = report["aggregate"]
    hooks_tel = {k: round(1e3 * v, 3) for k, v in spent.items() if k != "audit"}
    if {r["rid"]: r["tokens"] for r in report["requests"]} != clean:
        raise AssertionError("legT1: telemetry-only tokens differ from leg C1's")
    log(f"[legT1] tokens bitwise leg C1's; {len(tel.events)} events {dict(c)} equal to the "
        f"report's counters; {agg['audit_checks']} audits; Chrome trace of "
        f"{len(doc['traceEvents'])} entries parsed back; host ms in the hooks {hooks} "
        f"({1e3 * hooks['emit'] / len(tel.events):.1f} us an event), telemetry alone "
        f"{hooks_tel}; tokens/s: C1 untraced "
        f"{c1['tokens_per_s']}, telemetry + auditor {agg['tokens_per_s']}, telemetry alone "
        f"{tel_only['tokens_per_s']} (wall {c1['wall_s']} / {agg['wall_s']} / "
        f"{tel_only['wall_s']} s); launches {_nonzero(counts)}")
    legs = {"legT1": {"launches": counts, "aggregate": agg}}

    # T2: faults, then cancel and drain
    rids = [r.rid for r in trace()]
    victim = rids[0]
    plan = FaultPlan([Fault("poison_nan", rid=victim, block=2),
                      Fault("tick_delay", block=1, delay_s=0.002),
                      Fault("dispatch_fail", block=3)])
    eng.faults = plan
    report, counts = _counted_run(torch, "legT2", eng, trace())
    outcome, agg = _outcome(report), report["aggregate"]
    if (outcome[victim][:2] != ("errored", "nonfinite_logits")
            or (agg["faults_fired"], agg["dispatch_retries"], agg["n_errored"]) != (3, 1, 1)):
        raise AssertionError(f"legT2: victim {outcome[victim][:2]}, aggregate {agg}")
    _recovered("legT2", eng, outcome, clean, errored=(victim,))
    eng.faults = plan.replay()
    replayed = _outcome(eng.run(trace()))
    eng.faults = None
    if replayed != outcome:
        raise AssertionError("legT2: plan.replay() gave another report")
    legs["legT2"] = {"launches": counts, "aggregate": agg}
    log(f"[legT2] poison_nan victim {victim} errored nonfinite_logits after "
        f"{len(outcome[victim][2])} tokens ({tel.counts()['error_retire']} error_retire "
        f"event), {len(rids) - 1} bystanders bitwise leg C1's, {agg['faults_fired']} faults "
        f"fired, {agg['dispatch_retries']} dispatch retry, no slot held; replay identical; "
        f"launches {_nonzero(counts)}")
    cancelled = []

    def cancel(step):
        if step == 4:
            st = next(iter(eng.sched.decoding.values()), None)
            if st is None:
                raise AssertionError("legT2: no request in flight at step 4")
            eng.cancel(st.rid)
            cancelled.append(st.rid)
    report, _ = _counted_run(torch, "legT2 cancel", eng, trace(), cancel)
    outcome = _outcome(report)
    if (outcome[cancelled[0]][:2] != ("retired", "cancelled")
            or report["aggregate"]["n_cancelled"] != 1):
        raise AssertionError(f"legT2: cancelled request {outcome[cancelled[0]][:2]}")
    _recovered("legT2 cancel", eng, outcome, clean, partial=(cancelled[0],))
    n_cancel = len(outcome[cancelled[0]][2])
    report, _ = _counted_run(torch, "legT2 drain", eng, trace(),
                             lambda step: step == 4 and eng.drain())
    outcome, agg = _outcome(report), report["aggregate"]
    shed = [rid for rid, (st, code, _) in outcome.items() if st == "shed"]
    if (not shed or not agg.get("drained") or agg["n_retired"] + len(shed) != len(rids)
            or any(outcome[rid][1] != "drain" for rid in shed)):
        raise AssertionError(f"legT2: drain ended {agg}")
    _recovered("legT2 drain", eng, outcome, clean)
    log(f"[legT2] cancel of in-flight request {cancelled[0]} at step 4: retired "
        f"'cancelled' after {n_cancel} "
        f"tokens; drain at step 4: {agg['n_retired']} in flight finished bitwise leg C1's, "
        f"{len(shed)} queued shed 'drain'; no slot held; leg took "
        f"{time.perf_counter() - t_leg:.1f} s")
    return legs


def _ingest_fault_leg(torch, leg_w2) -> dict:
    """Leg T3: leg W2's engine (whisper-small at full size, the source-KV
    pool) under a ``FaultPlan`` of one ``ingest_fail`` victim: the victim
    errored ``source_ingest_failed`` with no token, every bystander bitwise
    W2's, both pools empty; launch-counted."""
    from repro_torch.serving import Fault, FaultPlan, poisson_trace
    t_leg = time.perf_counter()
    eng, clean = leg_w2.pop("engine"), leg_w2["tokens"]
    trace = poisson_trace(vocab_size=eng.model.cfg.vocab_size, rate=None, **LEG_W2_TRACE)
    victim = trace[1].rid
    eng.faults = FaultPlan([Fault("ingest_fail", rid=victim)])
    report, counts = _counted_run(torch, "legT3", eng, trace)
    eng.faults = None
    outcome, agg = _outcome(report), report["aggregate"]
    if outcome[victim] != ("errored", "source_ingest_failed", []) or agg["n_errored"] != 1:
        raise AssertionError(f"legT3: victim {outcome[victim]}")
    _recovered("legT3", eng, outcome, clean, errored=(victim,))
    log(f"[legT3] ingest_fail victim {victim} errored source_ingest_failed with no token, "
        f"{len(trace) - 1} bystanders bitwise leg W2's, slot and source pools empty "
        f"({agg['source_ingests']} ingests, {agg['source_shares']} shares); launches "
        f"{_nonzero(counts)}; "
        f"leg took {time.perf_counter() - t_leg:.1f} s")
    return {"launches": counts, "aggregate": agg}


def _stack(model) -> tuple[int, int, int]:
    """(self layers, dedicated cross layers, layers that read a source) of
    the model that serves decode (an encoder-decoder's decoder)."""
    m = getattr(model, "decoder", model)
    n_cross = m._n_cross_groups()
    return m.cfg.n_layers - n_cross, n_cross, m._n_cross_kv()


def _continuous_expect(torch, model, ticks, chunks, ingests) -> dict:
    """The launches a continuous run must make: per tick and self layer one
    decode attention (the ring form on a ring config), per tick and
    source-reading layer one pooled read (``entries=``); on +w4a8 one
    decode-form GEMV per projection, layer and tick and one prefill-form
    quantize + GEMM per projection, layer and chunk (``_w4a8_projections``;
    a cross read projects wq and wo, a vision cross layer also its MLP),
    and per source ingest the cross layers' wk and wv (and an encoder's
    projections) in the prefill form."""
    cfg = model.cfg
    ring = bool(cfg.kv_ring and cfg.window)
    n_self, n_cross, n_ckv = _stack(model)
    quant, proj = cfg.w4a8_serve, _w4a8_projections(cfg)
    counts = {}
    if cfg.family != "ssm":                                       # RWKV6: no attention
        counts["swiftkv_decode" + ("_ring" if ring else "") + ("_int8" if quant else "")] = \
            n_self * ticks
    if n_ckv:
        counts["swiftkv_decode_pooled" + ("_int8" if quant else "")] = n_ckv * ticks
    if _takes_mma(torch, cfg):
        counts["swiftkv_decode_mma"] = (n_self + n_ckv) * ticks
    if quant:
        per_step = n_self * proj + (n_cross * (4 + cfg.gated_mlp) if n_cross else 2 * n_ckv)
        per_ingest = 2 * n_ckv + cfg.encoder_layers * (4 + 2 + cfg.gated_mlp)
        counts.update(gemv_w4a8_decode=per_step * ticks,
                      gemv_w4a8_quant=per_step * chunks + per_ingest * ingests,
                      gemv_w4a8=per_step * chunks + per_ingest * ingests)
    return _expect(**counts)


def _ring_reuse(label, eng, trace, occupants, setup):
    """A ring leg's own checks: some slot was taken over from an occupant
    whose positions wrapped the ring (asserted), and the ring's rows and
    bytes per slot beside those of the linear twin's cache (printed)."""
    from repro_torch.models.api import build_model
    cfg = eng.model.cfg
    rows = int(eng.cache["k"].shape[2])
    final = {r.rid: len(r.prompt) + r.max_new_tokens - 1 for r in trace}
    reused, last = [], {}
    for slot, rid in occupants:
        if slot in last and final[last[slot]] > rows:
            reused.append(f"slot {slot}: {last[slot]} -> {rid}")
        last[slot] = rid
    wraps = {r.rid: "prefill" if len(r.prompt) > rows else "decode"
             for r in trace if final[r.rid] > rows}
    log(f"[{label}] ring of {rows} slots: requests that wrap it, and where: {wraps}; slots "
        f"taken over from a wrapped occupant: {reused or 'none'}")
    if not reused:
        raise AssertionError(f"{label}: no slot was reused after an occupant that wrapped "
                             "the ring")
    twin = build_model(cfg.replace(kv_ring=False, name=cfg.name.replace("+ring", "")),
                       device=eng.device)
    tcache = twin.init_cache(setup["n_slots"], setup["max_len"], chunk=setup["chunk"])
    tbytes = sum(tcache[k].numel() * tcache[k].element_size()
                 for k in ("k", "v", "k_scale", "v_scale") if k in tcache)
    kbytes = sum(eng.cache[k].numel() * eng.cache[k].element_size()
                 for k in ("k", "v", "k_scale", "v_scale") if k in eng.cache)
    log(f"[{label}] kv_rows_per_slot {rows} (linear twin {tcache['k'].shape[2]}); "
        f"kv_bytes_per_slot {kbytes // setup['n_slots']} (twin "
        f"{tbytes // setup['n_slots']}), {kbytes / 1e9:.3f} GB for {setup['n_slots']} "
        f"slots (twin {tbytes / 1e9:.3f} GB)")
    del tcache



def _sync_free_block(torch, label, model, params, trace, setup):
    """Check 5: two slots prefilled and committed, then one greedy and one
    sampled decode_multi block of K = 8 with the sync-debug mode raising on
    any host synchronization. A cross-attention model first ingests the two
    requests' sources into pool entries 0 and 1; each layer's pooled read
    alone is then held against the dense oracle (``_pooled_read_check``)."""
    from repro_torch.core import prng
    n_ckv = _stack(model)[2]
    src_rows = model.cfg.source_len if n_ckv else None
    cache = model.init_cache(setup["n_slots"], setup["max_len"], src_rows,
                             n_sources=setup["n_slots"] if n_ckv else None,
                             chunk=setup["chunk"])
    dev = model.device
    with torch.inference_mode():
        for slot, r in enumerate(trace[:2]):
            if n_ckv:
                padded = torch.zeros((src_rows, model.cfg.d_model))
                padded[:len(r.source)] = torch.from_numpy(r.source)
                model.ingest_source(params, padded.to(dev), cache, slot, len(r.source))
                model.assign_source(cache, slot, slot)
            prompt = torch.from_numpy(r.prompt).to(dev)
            chunk = setup["chunk"]
            for off in range(0, len(r.prompt), chunk):
                part = prompt[off:off + chunk]
                part = torch.nn.functional.pad(part, (0, chunk - len(part)))
                model.prefill_chunk(params, part, cache, slot, off,
                                    min(chunk - 1, len(r.prompt) - 1 - off))
            model.finalize_slot(cache, slot, len(r.prompt))
        n = setup["n_slots"]
        i32 = dict(dtype=torch.int32, device=dev)
        tok = torch.full((n,), 1, **i32)
        active = torch.arange(n, device=dev) < 2
        budget = torch.full((n,), 64, **i32)
        serials = torch.arange(n, **i32)
        emitted = torch.ones((n,), **i32)
        key = prng.prng_key(0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            greedy, *_ = model.decode_multi(params, tok, cache, active, budget, serials,
                                            emitted, 8)
            sampled, *_ = model.decode_multi(params, tok, cache, active, budget, serials,
                                             emitted, 8, temperature=0.8, base_key=key)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        greedy, sampled = greedy.cpu(), sampled.cpu()
    if not ((greedy[:, :2] >= 0).all() and (greedy[:, 2:] == -1).all()
            and (sampled[:, :2] >= 0).all()):
        raise AssertionError(f"{label}: bad decode_multi blocks {greedy} {sampled}")
    log(f"[{label}] check 5: a greedy and a sampled decode_multi block of K = 8 ran under "
        f"set_sync_debug_mode('error') with no host synchronization")
    if n_ckv:
        _pooled_read_check(torch, label, model, cache)

    # the run's two units of work alone (host clock around synchronized
    # calls, median of 3): a chunk ending at half of max_len (offset 384 in
    # leg C) in a free slot, and a greedy block with every slot active at
    # that length, per tick, at K = 1 and 8
    def median_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    with torch.inference_mode():
        chunk, half = setup["chunk"], setup["max_len"] // 2
        part = torch.zeros(chunk, dtype=torch.int64, device=dev)
        chunk_ms = median_ms(lambda: model.prefill_chunk(params, part, cache, n - 1,
                                                         half - chunk, chunk - 1))
        cache["len"][:] = half
        every = torch.ones(n, dtype=torch.bool, device=dev)
        tick = {k: median_ms(lambda k=k: model.decode_multi(
            params, tok, cache, every, budget, serials, emitted, k)) / k for k in (1, 8)}
    log(f"[{label}] alone: a {chunk}-token prefill chunk at offset {half - chunk} "
        f"{chunk_ms:.2f} ms; a decode tick at {n} active slots, length ~{half}: {tick[1]:.2f} ms "
        f"(K = 1), {tick[8]:.2f} ms per tick (K = 8)")
    del cache


def _pooled_read_check(torch, label, model, cache) -> None:
    """Each source-reading layer's pooled read alone, before its gate: the
    kernel's ``entries=`` form on the pool (slots 0 and 1 on entries 0 and
    1, the others on empty entries), for a bf16 query, against the dense
    oracle on the gathered entries; worst max |difference| over the layers
    as a fraction of max |output|, limit 2^-7 (two bf16 roundings)."""
    from repro_torch.core import attention as attn_lib
    from repro_torch.kernels import LAUNCHES
    cfg = model.cfg
    n = cache["src_index"].shape[0]
    entries = torch.tensor([0, 1, 0, 1] + [2] * (n - 4), dtype=torch.int32,
                           device="cuda")[:n]
    with torch.inference_mode():
        q = torch.randn((n, cfg.n_heads, cfg.resolved_head_dim), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5)
                        ).to(getattr(torch, cfg.compute_dtype))
        lengths = cache["src_len"][entries.long()]
        worst, before = 0.0, dict(LAUNCHES)
        for j in range(cache["src_k"].shape[0]):
            sc = ({"k_scale": cache["src_k_scale"][j], "v_scale": cache["src_v_scale"][j]}
                  if "src_k_scale" in cache else {})
            args = (q, cache["src_k"][j], cache["src_v"][j], entries, lengths)
            got = attn_lib.decode_cross_attention(*args, impl="kernel", **sc).float()
            want = attn_lib.decode_cross_attention(*args, impl="naive", **sc).float()
            scale = want.abs().max().item()
            if not scale > 0 or not (got[4:] == 0).all().item():
                raise AssertionError(f"{label}: a pooled read of layer {j} is all zero, or "
                                     "a read of an empty entry is not 0")
            worst = max(worst, (got - want).abs().max().item() / scale)
        LAUNCHES.update(before)
    log(f"[{label}] pooled cross read alone (entries=, before the gate), kernel vs dense "
        f"oracle over {cache['src_k'].shape[0]} layers, source lengths "
        f"{lengths.tolist()}: worst max_abs_err {worst:.3g} of max |out| (limit "
        f"{2 ** -7:.3g}; last layer's max |out| {scale:.3g}); empty entries exact 0")
    if worst > 2 ** -7:
        raise AssertionError(f"{label}: a pooled cross read is off the oracle by {worst:.3g}")


AGREE_REQUESTS = 2   # check 6's requests: all 16 of a trace cost ~270 s of the
                     # script's 1200 (eager lock-step decode, one row at a time);
                     # 4 cost 94 s on a host where the script took 1097.7 s


def _lockstep_agreement(torch, label, model, params, trace, got, max_len):
    """Check 6 (printed): the first ``AGREE_REQUESTS`` requests' greedy
    tokens from lock-step ``ServingEngine(batch=1).generate`` against their
    continuous tokens, with
    the first divergence and the lock-step top-2 logit gap there (the gaps
    are taken from the logits ``generate`` itself computes, recorded on the
    device by wrapping the model's prefill and decode_step). A request's
    source goes to lock-step as a batch of one (per-row cross reads)."""
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    sourced = trace[0].source is not None
    src_rows = model.cfg.source_len if sourced else None
    lock = ServingEngine(model, params, max_len=max_len, batch=1, source_len=src_rows)
    gaps = []

    def recording(fn):
        def call(*args, **kw):
            logits, cache = fn(*args, **kw)
            top = logits[0].float().topk(2).values
            gaps.append(top[0] - top[1])
            return logits, cache
        return call

    model.prefill, model.decode_step = recording(model.prefill), recording(model.decode_step)
    parts, equal, total = [], 0, 0
    try:
        for r in trace[:AGREE_REQUESTS]:
            gaps.clear()
            prompt = torch.from_numpy(r.prompt).to(model.device)[None]
            kw = {}
            if sourced:
                padded = torch.zeros((1, src_rows, model.cfg.d_model))
                padded[0, :len(r.source)] = torch.from_numpy(r.source)
                kw = {"source": padded.to(getattr(torch, model.cfg.compute_dtype)),
                      "source_len": torch.tensor([len(r.source)], dtype=torch.int32)}
            want = lock.generate(prompt, steps=r.max_new_tokens, **kw)[0].tolist()
            mine = got[r.rid]
            same = sum(a == b for a, b in zip(mine, want))
            equal, total = equal + same, total + len(want)
            first = next((i for i, (a, b) in enumerate(zip(mine, want)) if a != b), None)
            parts.append(f"{r.rid}: {same}/{len(want)}" if first is None else
                         f"{r.rid}: {same}/{len(want)} (first at {first}, gap "
                         f"{float(gaps[first]):.4f})")
    finally:
        del model.prefill, model.decode_step          # the class's methods again
    log(f"[{label}] check 6 (measured, {time.perf_counter() - t0:.1f} s): token agreement "
        f"of the first {AGREE_REQUESTS} requests with lock-step ServingEngine(batch=1) "
        f"{equal}/{total} = {equal / total:.4f}; by "
        "request (tokens equal/budget, first divergence, lock-step top-2 gap there) "
        + "; ".join(parts))


def _init_weights(torch, label, model):
    """Random bf16 weights of ``model`` on the card, from seed 0."""
    t0 = time.perf_counter()
    params = model.init_params(0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    items = [t for _, t in _items(params)]
    log(f"[{label}] {model.cfg.name}: {sum(t.numel() for t in items) / 1e9:.2f} B random "
        f"bf16 parameters ({sum(t.numel() * t.element_size() for t in items) / 1e9:.2f} GB) "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    return params


# ---- the distribution layer on one card: a one-rank NCCL world -----------

@contextlib.contextmanager
def _one_rank_world(torch, label):
    """A one-rank NCCL process group (the card's one GPU; NCCL allows one
    rank per GPU) at a free port of this host, its (data 1, model 1)
    ``DeviceMesh``, installed as the distribution context; cleared and
    destroyed on the way out. A failed init or collective fails the run."""
    import socket
    import torch.distributed as dist
    from repro_torch.distributed.context import clear_context, set_context
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        ctx = set_context(mesh, batch_axes=("data",), model_axis="model")
        log(f"[{label}] one-rank NCCL world, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
            f" set as the context in {time.perf_counter() - t0:.1f} s")
        yield ctx
    finally:
        clear_context()
        dist.destroy_process_group()


def _events_ms(torch, fn, runs: int = 25) -> float:
    """Median device time of eager ``fn()`` calls between CUDA events (no
    graph capture: a collective inside is not captured)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SP1_STEPS = 32
SP1_LOGIT_TOL = 1e-3       # of the logit range: the sp fold and blockwise fold
                           # the same 512-key blocks in the same order


def _sp_leg(torch, params, leg_a, steps=SP1_STEPS) -> dict:
    """Leg SP1: leg A's llama2-7b bf16 weights through ``decode_impl="sp"``
    under a one-rank (1, 1) context (batch 8, prompt 512, 32 greedy steps):
    greedy tokens equal the same weights' blockwise run without a context,
    teacher-forced logits within SP1_LOGIT_TOL of the logit range, no
    kernel launch, one state all-gather a layer and step. Then
    ``decode_attention_sp`` alone at leg A's shape beside the fold kernel
    and the plain version (eager, CUDA events)."""
    from repro_torch.configs import get_config
    from repro_torch.core import attention as attn
    from repro_torch.distributed.context import COLLECTIVES
    from repro_torch.distributed.sp_attention import decode_attention_sp
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops
    from repro_torch.models.api import build_model
    from repro_torch.serving import ServingEngine
    t_leg = time.perf_counter()
    cfg = get_config("llama2-7b")
    prompts = leg_a["prompts"]
    b, plen = prompts.shape
    max_len = plen + steps
    bw = build_model(cfg.replace(decode_impl="blockwise"))
    want = ServingEngine(bw, params, max_len=max_len, batch=b).generate(prompts,
                                                                        steps=steps).cpu()
    with _one_rank_world(torch, "legSP1") as ctx:
        sp = build_model(cfg.replace(decode_impl="sp"))
        eng = ServingEngine(sp, params, max_len=max_len, batch=b)
        eng.generate(prompts, steps=2)                           # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, steps=0).cpu()
        prefill_s = time.perf_counter() - t0
        reset_launches()
        for k in COLLECTIVES:
            COLLECTIVES[k] = 0
        t0 = time.perf_counter()
        out = eng.generate(prompts, steps=steps).cpu()
        wall = time.perf_counter() - t0
        counts, coll = dict(LAUNCHES), dict(COLLECTIVES)
        decode_ms = 1e3 * (wall - prefill_s) / steps
        per_call = coll["sp_all_gather_bytes"] // max(coll["sp_all_gather"], 1)
        log(f"[legSP1] {cfg.name} decode_impl=sp, mesh (1, 1): batch {b}, prompt {plen}, "
            f"{steps} greedy steps; prefill {1e3 * prefill_s:.1f} ms, eager decode "
            f"{decode_ms:.2f} ms/step (leg A's kernel step {leg_a['decode_ms_per_step']:.2f} "
            f"ms/step); {coll['sp_all_gather']} state all-gathers of {per_call} bytes "
            f"({b} x {cfg.n_heads} x ({cfg.resolved_head_dim} + 2) x 4); launches {counts}; "
            f"{card_line()}")
        if any(counts.values()):
            raise AssertionError(f"legSP1: kernel launches {counts} on the sp route")
        if coll["sp_all_gather"] != cfg.n_layers * steps:
            raise AssertionError(f"legSP1: {coll['sp_all_gather']} all-gathers, expected one "
                                 f"a layer and step ({cfg.n_layers * steps})")
        if per_call != b * cfg.n_heads * (cfg.resolved_head_dim + 2) * 4:
            raise AssertionError(f"legSP1: {per_call} bytes an all-gather")
        if not torch.equal(out, want):
            raise AssertionError(f"legSP1: sp tokens differ from blockwise's at "
                                 f"{(out != want).nonzero()[:4].tolist()}")
        worst = 0.0
        with torch.inference_mode():
            c_bw, c_sp = bw.init_cache(b, max_len), sp.init_cache(b, max_len)
            l_bw, c_bw = bw.prefill(params, prompts, c_bw)
            l_sp, c_sp = sp.prefill(params, prompts, c_sp)
            for _ in range(steps):
                rng = (l_bw.max() - l_bw.min()).item()
                worst = max(worst, (l_bw - l_sp).abs().max().item() / rng)
                tok = l_bw.argmax(-1).to(torch.int32)
                l_bw, c_bw = bw.decode_step(params, tok, c_bw)
                l_sp, c_sp = sp.decode_step(params, tok, c_sp)
            del c_bw, c_sp
        log(f"[legSP1] tokens equal blockwise's; teacher-forced logits within {worst:.3g} of "
            f"the logit range (limit {SP1_LOGIT_TOL})")
        if worst > SP1_LOGIT_TOL:
            raise AssertionError(f"legSP1: logits {worst} of the range from blockwise's")
        # decode_attention_sp alone at leg A's shape, beside the fold and the plain version
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, lens, _ = _swiftkv_inputs(torch, gen, 8, 32, 32, 576, 128, torch.bfloat16,
                                           lengths=[576] * 8)
        call = lambda: decode_attention_sp(q, k, v, lens, mesh=ctx.mesh, seq_axes="model")
        kern = lambda: skv_ops.swiftkv_decode(q, k, v, lens)
        plain = lambda: attn.decode_attention(q, k, v, lens, impl="blockwise")
        reset_launches()
        err_plain = (call().float() - plain().float()).abs().max().item()
        err_kern = (call().float() - kern().float()).abs().max().item()
        sp_ms, kern_ms, plain_ms = (_events_ms(torch, f) for f in (call, kern, plain))
        log(f"[legSP1] decode_attention_sp alone, B 8, 32/32 heads, D 128, len 576: "
            f"{sp_ms:.4f} ms (eager, events; the fold kernel {kern_ms:.4f} ms, the plain "
            f"blockwise version {plain_ms:.4f} ms); max |sp - plain| {err_plain:.3g}, "
            f"|sp - kernel| {err_kern:.3g}; {card_line()}")
        if err_plain > 1e-2 or err_kern > 1e-2:
            raise AssertionError(f"legSP1: decode_attention_sp off by {err_plain}, {err_kern}")
    log(f"[legSP1] leg took {time.perf_counter() - t_leg:.1f} s")
    return {"decode_ms_per_step": decode_ms, "prefill_ms": 1e3 * prefill_s, "launches": counts,
            "all_gathers": coll["sp_all_gather"], "bytes_per_all_gather": per_call,
            "sp_alone_ms": sp_ms, "kernel_ms": kern_ms, "plain_ms": plain_ms}


def _ep_leg(torch, model, params, leg_m1, m1_drops) -> dict:
    """Leg EP1: leg M1's olmoe-1b-7b weights, lock-step 8 x 512 with 64
    greedy steps as M1, under a one-rank (1, 1) context: the prefill's MoE
    layers take the expert-parallel route (one all-reduce each), decode
    stays ``moe_apply_rowwise``. With ep = dp = 1 the capacity is M1's and
    the all-reduce the identity, so the tokens are M1's bit for bit and the
    dispatch drops M1's share of (token, expert) pairs."""
    from repro_torch.distributed.context import COLLECTIVES
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import moe
    from repro_torch.serving import ServingEngine
    t_leg = time.perf_counter()
    cfg = model.cfg
    prompts = leg_m1["prompts"]
    b, plen = prompts.shape
    steps = leg_m1["tokens"].shape[1]
    drops, dispatch = [], moe._dispatch_ffn_combine

    def recording(p, xf, top_e, top_w, **kw):
        keep = moe._queue_positions(top_e, p["router"].shape[-1], kw["c"])[2]
        drops.append((int((~keep).sum()), keep.numel()))
        return dispatch(p, xf, top_e, top_w, **kw)

    with _one_rank_world(torch, "legEP1"):
        eng = ServingEngine(model, params, max_len=plen + steps, batch=b)
        eng.generate(prompts, steps=2)                           # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, steps=0).cpu()
        prefill_s = time.perf_counter() - t0
        reset_launches()
        for k in COLLECTIVES:
            COLLECTIVES[k] = 0
        with _swapped(moe, "_dispatch_ffn_combine", recording):
            out = eng.generate(prompts, steps=steps).cpu()
        counts, coll = dict(LAUNCHES), dict(COLLECTIVES)
    dropped, total = sum(d for d, _ in drops), sum(n for _, n in drops)
    log(f"[legEP1] {cfg.name} expert-parallel prefill, mesh (1, 1): prefill "
        f"{1e3 * prefill_s:.1f} ms (leg M1's {leg_m1['prefill_ms']:.1f} ms); "
        f"{coll['ep_all_reduce']} all-reduces of {coll['ep_all_reduce_bytes']} bytes; "
        f"{dropped} of {total} (token, expert) assignments dropped ({dropped / total:.4%}, "
        f"M1 {m1_drops[0] / m1_drops[1]:.4%}); launches {counts} (M1's decode); "
        f"{card_line()}")
    if coll["ep_all_reduce"] != cfg.n_layers:
        raise AssertionError(f"legEP1: {coll['ep_all_reduce']} all-reduces, expected one a "
                             f"MoE layer ({cfg.n_layers})")
    if (dropped, total) != tuple(m1_drops):
        raise AssertionError(f"legEP1: drops {(dropped, total)} != M1's {m1_drops}")
    if counts != leg_m1["launches"]:
        raise AssertionError(f"legEP1: launches {counts} != M1's {leg_m1['launches']}")
    if not torch.equal(out, leg_m1["tokens"]):
        raise AssertionError(f"legEP1: tokens differ from M1's at "
                             f"{(out != leg_m1['tokens']).nonzero()[:4].tolist()}")
    log(f"[legEP1] tokens bitwise leg M1's; leg took {time.perf_counter() - t_leg:.1f} s")
    # no "launches" key: its decode repeats M1's kernel calls, which the
    # kernels' rows count once (phase_timings)
    return {"prefill_ms": 1e3 * prefill_s, "all_reduces": coll["ep_all_reduce"],
            "dropped": dropped, "total": total}


def phase_legs(torch, dev: dict, breakdown: bool, breakdown_only: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.quantized import quantize_params
    cfg = get_config("llama2-7b").replace(decode_impl="kernel")
    model = build_model(cfg)
    params = _init_weights(torch, "legA", model)
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
        expect=_expect(swiftkv_decode=n_layers * steps),
        plain_model=build_model(cfg.replace(decode_impl="blockwise")),
        # float32: the paths differ only in summation order, ~1e-7 per call.
        # bf16: the residual stream is rounded at points one ulp of
        # difference can move, and such flips compound over 32 layers.
        rel_tols={"bfloat16": 0.10, "float32": 1e-3}, mem_bps=dev["mem_bps"],
        breakdown=breakdown)
    leg_sp = _sp_leg(torch, params, leg_a)
    leg_f = _tokenwise_leg(torch, model, params)
    leg_c1 = _continuous_leg(torch, "legC1", model, params)
    extras = _extras_legs(torch, model, params, leg_c1)

    cfg_q = get_config("llama2-7b+w4a8").replace(decode_impl="kernel")
    t0 = time.perf_counter()
    params_q = quantize_params(params)
    torch.cuda.synchronize()
    log(f"[legB] quantize_params on the card: {time.perf_counter() - t0:.1f} s")
    del params
    leg_b = _serve_leg(
        torch, "legB", build_model(cfg_q), params_q, prompt_len=128, steps=steps,
        # every decode-step projection is one decode-form launch (M = 8);
        # every prefill projection (M = 1024) one quantize and one GEMM
        expect=_expect(swiftkv_decode_int8=n_layers * steps,
                       gemv_w4a8_decode=7 * n_layers * steps, gemv_w4a8_quant=7 * n_layers,
                       gemv_w4a8=7 * n_layers),
        plain_model=build_model(cfg_q.replace(decode_impl="blockwise")),
        # in either dtype a ~1e-7 difference of a GEMV output can move an
        # int8 activation code, and moved codes compound over 32 layers:
        # the limit comes from the witness runs (see _compare_paths)
        rel_tols={"bfloat16": None, "float32": None}, mem_bps=dev["mem_bps"],
        breakdown=breakdown)
    leg_c2 = _continuous_leg(torch, "legC2", build_model(cfg_q), params_q)
    return {"legA": leg_a, "legB": leg_b, "legC1": leg_c1, "legC2": leg_c2, "legF": leg_f,
            "legSP1": leg_sp, **extras}


def _ring_vs_twin(torch, label, ring_model, twin_model, params, prompts, steps):
    """Leg D1's twin: the ring model and its linear twin (the same model on
    a full cache, windowed by masking) on the same weights and prompts,
    prefill and ``steps`` greedy steps each; every step's logits must agree
    bit for bit. The kernel's ring form folds the window's positions in the
    same tiles and order as its linear form (both caches give the same
    n_split), and everything else is the same arithmetic."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    t0 = time.perf_counter()

    def run(model):
        reset_launches()
        with torch.inference_mode():
            cache = model.init_cache(prompts.shape[0], prompts.shape[1] + steps)
            logits, cache = model.prefill(params, prompts, cache)
            outs = [logits]
            for _ in range(steps):
                logits, cache = model.decode_step(params, logits.argmax(-1).to(torch.int32),
                                                  cache)
                outs.append(logits)
            nbytes = sum(cache[k].numel() * cache[k].element_size()
                         for k in ("k", "v", "k_scale", "v_scale") if k in cache)
            rows = cache["k"].shape[2]
            del cache
        return torch.stack(outs), rows, nbytes, LAUNCHES["swiftkv_decode_mma"]

    ring_l, ring_rows, ring_bytes, ring_mma = run(ring_model)
    twin_l, twin_rows, twin_bytes, twin_mma = run(twin_model)
    want_mma = ring_model.cfg.n_layers * steps
    same = torch.equal(ring_l, twin_l)
    differ = (ring_l != twin_l).flatten(1).any(1).nonzero()
    first = None if not len(differ) else int(differ[0])
    agree = (ring_l.argmax(-1) == twin_l.argmax(-1)).float().mean().item()
    log(f"[{label}] ring ({ring_rows} slots, {ring_bytes / 1e9:.3f} GB of KV cache) against "
        f"its linear twin {twin_model.cfg.name} ({twin_rows} rows, {twin_bytes / 1e9:.3f} GB), "
        f"prefill + {steps} greedy steps: logits bitwise equal at every step {same} (first "
        f"differing step {first}, max_abs_err {(ring_l - twin_l).abs().max().item():.3g}), "
        f"token agreement {agree:.4f}; GQA-form launches ring {ring_mma}, twin {twin_mma} "
        f"(expected {want_mma} each); {time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError(f"{label}: ring logits differ from the linear twin's")
    if ring_mma != want_mma or twin_mma != want_mma:
        raise AssertionError(f"{label}: the ring or its twin did not decode through the "
                             "GQA form")


def phase_ring_legs(torch, dev: dict, breakdown: bool, breakdown_only: bool = False) -> dict:
    """Legs D1, D2 and E: h2o-danube-1.8b at its published width on ring KV
    caches (window 4096): D1 ``+ring`` lock-step with its linear twin, E
    ``+ring`` continuous on D1's weights, D2 ``+ring+w4a8`` lock-step.
    ``breakdown_only``: D1's and D2's prefill and decode-step breakdown
    alone."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.quantized import quantize_params
    cfg = get_config("h2o-danube-1.8b+ring").replace(decode_impl="kernel")
    model = build_model(cfg)
    params = _init_weights(torch, "legD1", model)
    n_layers, prompt_len, steps = cfg.n_layers, 4160, 128
    if breakdown_only:
        _breakdown_only(torch, "legD1", model, params, prompt_len, steps, dev["mem_bps"])
        cfg_q = get_config("h2o-danube-1.8b+ring+w4a8").replace(decode_impl="kernel")
        params_q = quantize_params(params)
        del params
        _breakdown_only(torch, "legD2", build_model(cfg_q), params_q, prompt_len, steps,
                        dev["mem_bps"])
        return {}
    # R = round128(4096 + 1) = 4224: the window masks from the first step,
    # and the ring wraps at step 64
    leg_d1 = _serve_leg(
        torch, "legD1", model, params, prompt_len=prompt_len, steps=steps,
        # every decode attention the ring form, on the GQA form's kernel
        expect=_expect(swiftkv_decode_ring=n_layers * steps,
                       swiftkv_decode_mma=n_layers * steps),
        plain_model=build_model(cfg.replace(decode_impl="blockwise")),
        # as leg A: f32 paths differ in summation order only; bf16 roundings
        # that one ulp can move compound over the 24 layers
        rel_tols={"bfloat16": 0.10, "float32": 1e-3}, mem_bps=dev["mem_bps"],
        breakdown=breakdown)
    twin = build_model(get_config("h2o-danube-1.8b").replace(decode_impl="kernel"))
    _ring_vs_twin(torch, "legD1", model, twin, params, leg_d1["prompts"], steps)
    del twin
    leg_e = _continuous_leg(torch, "legE", model, params, setup=LEG_E, trace_kw=LEG_E_TRACE,
                            n_solo=2, horizon=False)

    cfg_q = get_config("h2o-danube-1.8b+ring+w4a8").replace(decode_impl="kernel")
    t0 = time.perf_counter()
    params_q = quantize_params(params)
    torch.cuda.synchronize()
    log(f"[legD2] quantize_params on the card: {time.perf_counter() - t0:.1f} s")
    del params
    leg_d2 = _serve_leg(
        torch, "legD2", build_model(cfg_q), params_q, prompt_len=prompt_len, steps=steps,
        # every decode-step projection one decode-form launch (M = 8); every
        # prefill projection (M = 8 x 4160) one quantize and one GEMM
        expect=_expect(swiftkv_decode_ring_int8=n_layers * steps,
                       swiftkv_decode_mma=n_layers * steps,
                       gemv_w4a8_decode=7 * n_layers * steps, gemv_w4a8_quant=7 * n_layers,
                       gemv_w4a8=7 * n_layers),
        plain_model=build_model(cfg_q.replace(decode_impl="blockwise")),
        # as leg B: the limit comes from the witness runs
        rel_tols={"bfloat16": None, "float32": None}, mem_bps=dev["mem_bps"],
        breakdown=breakdown)
    return {"legD1": leg_d1, "legD2": leg_d2, "legE": leg_e}


def _moe_drops(torch, label, model, params, prompts, max_len) -> tuple[int, int]:
    """The lock-step prefill's (token, expert) assignments that its
    capacity drops, layer by layer: each capacity dispatch recounted on its
    own inputs (printed, not asserted: GShard's capacity drops by design)."""
    from repro_torch.models import moe
    drops, apply = [], moe.moe_apply

    def recording(p, x, **kw):
        t, e = x.shape[0] * x.shape[1], p["router"].shape[-1]
        c = kw.get("capacity") or moe.capacity_for(t, kw["top_k"], e, kw["capacity_factor"])
        top_e = moe._route(x.reshape(t, -1), p["router"], kw["top_k"])[0]
        keep = moe._queue_positions(top_e, e, c)[2]
        drops.append((int((~keep).sum()), keep.numel(), c))
        return apply(p, x, **kw)
    with torch.inference_mode(), _swapped(moe, "moe_apply", recording):
        cache = model.init_cache(prompts.shape[0], max_len)
        model.prefill(params, prompts, cache)
        del cache
    dropped, total = sum(d for d, _, _ in drops), sum(n for _, n, _ in drops)
    log(f"[{label}] prefill of {prompts.shape[0]} x {prompts.shape[1]} tokens, capacity "
        f"{drops[0][2]} places per expert: {dropped} of {total} (token, expert) assignments "
        f"dropped ({dropped / total:.4%}); by layer {[d for d, _, _ in drops]}")
    return dropped, total


def phase_family_legs(torch, dev: dict, breakdown: bool, breakdown_only: bool = False
                      ) -> dict:
    """The dense configs after llama2-7b and the MoE family, each at its
    published width with random bf16 weights from seed 0, each leg's
    weights freed before the next: chatglm-6b (the paper's second model:
    partial rotary, plain GELU MLP; the fold) as G1 lock-step, H
    continuous (leg C's setup and checks) and G2 ``+w4a8`` lock-step;
    gemma-2b (MQA: every decode attention the GQA form at G 8, D 256, one
    KV head) as I; mistral-nemo-12b (the GQA form at G 4, D 128) as J;
    olmoe-1b-7b (64 experts top-8, qk-norm; the fold) as M1 lock-step, with
    its prefill's dropped assignments, and M2 continuous. Lock-step legs
    are batch 8 with greedy steps, the kernel path held against the plain
    path as in leg A. ``breakdown_only``: one timed prefill and the
    decode-step breakdown of each lock-step leg."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.quantized import quantize_params
    legs = {}
    # as leg A: f32 paths differ in summation order only; bf16 roundings that
    # one ulp can move compound over the layers
    dense_tols = {"bfloat16": 0.10, "float32": 1e-3}

    def lockstep(label, model, params, prompt_len, steps, expect, rel_tols=dense_tols):
        if breakdown_only:
            _breakdown_only(torch, label, model, params, prompt_len, steps, dev["mem_bps"])
            return None
        return _serve_leg(torch, label, model, params, prompt_len=prompt_len, steps=steps,
                          expect=expect,
                          plain_model=build_model(model.cfg.replace(decode_impl="blockwise")),
                          rel_tols=rel_tols, mem_bps=dev["mem_bps"], breakdown=breakdown)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # chatglm-6b: G 1 (32/32 heads of 128), rotary on 64 of 128 dims
    cfg = get_config("chatglm-6b").replace(decode_impl="kernel")
    model = build_model(cfg)
    params = _init_weights(torch, "legG1", model)
    n = cfg.n_layers
    legs["legG1"] = lockstep("legG1", model, params, 512, 64,
                             _expect(swiftkv_decode=n * 64))
    if not breakdown_only:
        legs["legH"] = _continuous_leg(torch, "legH", model, params)
    cfg_q = get_config("chatglm-6b+w4a8").replace(decode_impl="kernel")
    t0 = time.perf_counter()
    params_q = quantize_params(params)
    torch.cuda.synchronize()
    log(f"[legG2] quantize_params on the card: {time.perf_counter() - t0:.1f} s")
    del params
    proj = _w4a8_projections(cfg_q)                 # 6: no gate in a plain MLP
    legs["legG2"] = lockstep(
        "legG2", build_model(cfg_q), params_q, 128, 64,
        _expect(swiftkv_decode_int8=n * 64, gemv_w4a8_decode=proj * n * 64,
                gemv_w4a8_quant=proj * n, gemv_w4a8=proj * n),
        # as leg B: the limit comes from the witness runs
        rel_tols={"bfloat16": None, "float32": None})
    del params_q, model
    free()

    # gemma-2b (MQA) and mistral-nemo-12b (GQA 32/8): the GQA form
    for label, arch, steps in (("legI", "gemma-2b", 64), ("legJ", "mistral-nemo-12b", 32)):
        cfg = get_config(arch).replace(decode_impl="kernel")
        model = build_model(cfg)
        if not _takes_mma(torch, cfg):
            raise AssertionError(f"{label}: {arch} does not take the GQA form")
        params = _init_weights(torch, label, model)
        n = cfg.n_layers * steps
        legs[label] = lockstep(label, model, params, 512, steps,
                               _expect(swiftkv_decode=n, swiftkv_decode_mma=n))
        del params, model
        free()

    # olmoe-1b-7b: 16 heads of 128 on 16 KV heads (the fold), 64 experts top-8
    cfg = get_config("olmoe-1b-7b").replace(decode_impl="kernel")
    model = build_model(cfg)
    params = _init_weights(torch, "legM1", model)
    legs["legM1"] = lockstep(
        "legM1", model, params, 512, 64, _expect(swiftkv_decode=cfg.n_layers * 64),
        # bf16: a decode attention output one rounding off can change a
        # near-tied router's top-8, so the limit comes from the witness runs
        rel_tols={"bfloat16": None, "float32": 1e-3})
    if not breakdown_only:
        drops = _moe_drops(torch, "legM1", model, params, legs["legM1"]["prompts"], 512 + 64)
        legs["legEP1"] = _ep_leg(torch, model, params, legs["legM1"], drops)
        legs["legM2"] = _continuous_leg(torch, "legM2", model, params)
    del params, model
    free()
    return {k: v for k, v in legs.items() if v is not None}


def _chunked_vs_lockstep(torch, label, model, params, prompts, chunk=128) -> None:
    """A recurrent model's lock-step prefill (``model.prefill`` of the whole
    batch) against its chunked prefill (``prefill_chunk`` row by row, chunks
    of ``chunk``): the last position's logits and every state plane, as max
    |difference| over max |value|. The two run the same recurrence through
    matmuls of other shapes, so they agree up to rounding: asserted in
    float32 (limit 1e-3), printed in the serving dtype."""
    from repro_torch.models.api import build_model
    b, p = prompts.shape
    for dtype in (model.cfg.compute_dtype, "float32"):
        m = model if dtype == model.cfg.compute_dtype else build_model(
            model.cfg.replace(compute_dtype=dtype), device=model.device)
        with torch.inference_mode():
            lock = m.init_cache(b, p + 1)
            want, lock = m.prefill(params, prompts, lock)
            chunked = m.init_cache(b, p + 1, chunk=chunk)
            got = torch.stack([[m.prefill_chunk(params, prompts[r, off:off + chunk], chunked,
                                                r, off, chunk - 1)[0]
                                for off in range(0, p, chunk)][-1] for r in range(b)])
        rel = {"logits": (got - want).abs().max().item() / want.abs().max().item()}
        rel.update({k: ((chunked[k].float() - lock[k].float()).abs().max().item()
                        / lock[k].float().abs().max().item())
                    for k in RECURRENT_STATE if k in lock})
        del lock, chunked
        log(f"[{label}] lock-step prefill of {b} x {p} against chunked prefill (chunks of "
            f"{chunk}, row by row) in {dtype}: max |difference| / max |value| "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + (" (limit 1e-3)" if dtype == "float32" else " (printed)"))
        if dtype == "float32" and max(rel.values()) > 1e-3:
            raise AssertionError(f"{label}: chunked prefill state off the lock-step one")


# leg L: every prompt is past the 1152-slot ring (round128(1024 + 128))
LEG_L = {"n_slots": 4, "max_len": 2048, "chunk": 128, "decode_ticks": 8}
LEG_L_TRACE = {"n_requests": 8, "prompt_len": (1216, 1792), "max_new": (16, 64), "seed": 7}


def phase_recurrent_legs(torch, dev: dict, breakdown: bool, breakdown_only: bool = False
                         ) -> dict:
    """The recurrent families at published width, random bf16 weights from
    seed 0, each family's weights freed before the next. hymba-1.5b
    (attention and a Mamba branch side by side; window 1024): K1 ``+ring``
    lock-step (batch 8, prompt 1088, 128 greedy steps: a 1152-slot ring
    that wraps at step 64; every decode attention the ring form on the GQA
    form at G 5, D 64), kernel path against plain path, and every step's
    logits bit for bit those of its linear twin ``hymba-1.5b``; L ``+ring``
    continuous (leg E's checks); K2 ``+ring+w4a8``. rwkv6-3b (RWKV6: no KV
    cache and no kernel on its fp path): R1 lock-step (batch 8, prompt 512,
    64 steps; no kernel launches; its lock-step prefill state against its
    chunked prefill state), S continuous (leg C's setup and checks), R2
    ``+w4a8`` (prompt 128; wk, wv, wo on the GEMV). ``breakdown_only``: one
    timed prefill and the decode-step breakdown of K1, K2, R1 and R2."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.quantized import quantize_params
    legs = {}

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def quantized(label, params):
        t0 = time.perf_counter()
        params_q = quantize_params(params)
        torch.cuda.synchronize()
        log(f"[{label}] quantize_params on the card: {time.perf_counter() - t0:.1f} s")
        return params_q

    # hymba-1.5b: 25 query heads on 5 KV heads of 64 (G 5), window 1024; R =
    # round128(1024 + 1) = 1152, so a 1088-token prompt wraps it at step 64
    cfg = get_config("hymba-1.5b+ring").replace(decode_impl="kernel")
    cfg_q = get_config("hymba-1.5b+ring+w4a8").replace(decode_impl="kernel")
    model = build_model(cfg)
    if not _takes_mma(torch, cfg):
        raise AssertionError("legK1: hymba-1.5b does not take the GQA form")
    params = _init_weights(torch, "legK1", model)
    n, prompt_len, steps = cfg.n_layers, 1088, 128
    proj = _w4a8_projections(cfg_q)                 # 7: attention and the gated MLP
    if breakdown_only:
        _breakdown_only(torch, "legK1", model, params, prompt_len, steps, dev["mem_bps"])
        params_q = quantize_params(params)
        del params
        _breakdown_only(torch, "legK2", build_model(cfg_q), params_q, prompt_len, steps,
                        dev["mem_bps"])
    else:
        legs["legK1"] = _serve_leg(
            torch, "legK1", model, params, prompt_len=prompt_len, steps=steps,
            expect=_expect(swiftkv_decode_ring=n * steps, swiftkv_decode_mma=n * steps),
            plain_model=build_model(cfg.replace(decode_impl="blockwise")),
            # as leg A: f32 paths differ in summation order only; bf16
            # roundings that one ulp can move compound over the 32 layers
            rel_tols={"bfloat16": 0.10, "float32": 1e-3}, mem_bps=dev["mem_bps"],
            breakdown=breakdown)
        twin = build_model(get_config("hymba-1.5b").replace(decode_impl="kernel"))
        _ring_vs_twin(torch, "legK1", model, twin, params, legs["legK1"]["prompts"], steps)
        del twin
        legs["legL"] = _continuous_leg(torch, "legL", model, params, setup=LEG_L,
                                       trace_kw=LEG_L_TRACE, n_solo=2, horizon=False)
        params_q = quantized("legK2", params)
        del params
        legs["legK2"] = _serve_leg(
            torch, "legK2", build_model(cfg_q), params_q, prompt_len=prompt_len, steps=steps,
            # every decode-step projection one decode-form launch (M = 8); every
            # prefill projection (M = 8 x 1088) one quantize and one GEMM
            expect=_expect(swiftkv_decode_ring_int8=n * steps, swiftkv_decode_mma=n * steps,
                           gemv_w4a8_decode=proj * n * steps, gemv_w4a8_quant=proj * n,
                           gemv_w4a8=proj * n),
            plain_model=build_model(cfg_q.replace(decode_impl="blockwise")),
            # as leg B: the limit comes from the witness runs
            rel_tols={"bfloat16": None, "float32": None}, mem_bps=dev["mem_bps"],
            breakdown=breakdown)
    del params_q, model
    free()

    # rwkv6-3b: 40 heads of 64, no KV cache; its fp path launches no kernel
    cfg = get_config("rwkv6-3b").replace(decode_impl="kernel")
    cfg_q = get_config("rwkv6-3b+w4a8").replace(decode_impl="kernel")
    model = build_model(cfg)
    params = _init_weights(torch, "legR1", model)
    n, steps = cfg.n_layers, 64
    proj = _w4a8_projections(cfg_q)                 # 3: wk, wv, wo
    if breakdown_only:
        _breakdown_only(torch, "legR1", model, params, 512, steps, dev["mem_bps"])
        params_q = quantize_params(params)
        del params
        _breakdown_only(torch, "legR2", build_model(cfg_q), params_q, 128, steps,
                        dev["mem_bps"])
    else:
        # no kernel on the path, so no kernel-vs-plain comparison (rel_tols {})
        legs["legR1"] = _serve_leg(torch, "legR1", model, params, prompt_len=512, steps=steps,
                                   expect=_expect(), plain_model=None, rel_tols={},
                                   mem_bps=dev["mem_bps"], breakdown=breakdown)
        _chunked_vs_lockstep(torch, "legR1", model, params, legs["legR1"]["prompts"])
        legs["legS"] = _continuous_leg(torch, "legS", model, params)
        params_q = quantized("legR2", params)
        del params
        legs["legR2"] = _serve_leg(
            torch, "legR2", build_model(cfg_q), params_q, prompt_len=128, steps=steps,
            expect=_expect(gemv_w4a8_decode=proj * n * steps, gemv_w4a8_quant=proj * n,
                           gemv_w4a8=proj * n),
            plain_model=build_model(cfg_q.replace(decode_impl="blockwise")),
            rel_tols={"bfloat16": None, "float32": None}, mem_bps=dev["mem_bps"],
            breakdown=breakdown)
    del params_q, model
    free()
    return legs


# leg W2: whisper-small continuous, sources of 375-1500 frames shared by pairs
LEG_W2 = {"n_slots": 8, "max_len": 512, "chunk": 64, "decode_ticks": 8}
LEG_W2_TRACE = {"n_requests": 16, "prompt_len": (16, 128), "max_new": (16, 64),
                "source_len": (375, 1500), "source_dim": 768, "source_share": 2, "seed": 7}
# leg V2: leg C's setup, sources of 400-1600 patches shared by pairs
LEG_V2_TRACE = {**LEG_C_TRACE, "source_len": (400, 1600), "source_dim": 8192,
                "source_share": 2}
VISION_DEPTH = 20   # of 100 layers: 16 self + 4 cross, every width the published one


def _leg_sources(torch, cfg, shortest: int, batch: int = 8):
    """A lock-step leg's sources: ``batch`` x S_src x d bf16 features from
    seed 1, and each row's length drawn from [shortest, S_src] (row 0 the
    shortest, the last row S_src)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn((batch, cfg.source_len, cfg.d_model), generator=g,
                      device="cuda").to(torch.bfloat16)
    lens = torch.randint(shortest, cfg.source_len + 1, (batch,), generator=g, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[-1] = shortest, cfg.source_len
    return src, lens


def phase_xattn_legs(torch, dev: dict, breakdown: bool, breakdown_only: bool = False
                     ) -> dict:
    """The cross-attention configs, random bf16 weights from seed 0 with
    every cross gate set to 0.5 (0 at the reference's init, where the cross
    terms would vanish). whisper-small at full size (12 encoder and 12
    decoder layers, d 768, 12 heads of 64; its reads take the fold, G 1):
    W1 lock-step (batch 8, sources of 375-1500 frames, prompt 64, 64 greedy
    steps: 12 self and 12 per-row cross reads a step), W2 continuous (8
    slots, max_len 512, chunk 64, decode_ticks 8, 16 requests whose sources
    are shared by pairs: the pooled reads, ``entries=``). llama-3.2-vision-90b
    at depth 20 of 100 (16 self and 4 cross layers, every width the
    published one: d 8192, 64/8 heads of 128, d_ff 28672; its reads take
    the GQA form, G 8): V1 lock-step bf16 (batch 8, sources of 400-1600
    patches, prompt 512, 32 steps), V2 ``+w4a8`` continuous on V1's weights
    quantized, then freed (leg C's setup; the int8 pool). Lock-step legs
    hold the kernel path against the plain path and each cross read alone
    against the oracle, and always break their decode step down;
    continuous legs run leg C's checks and the pooled read alone."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.quantized import quantize_params
    legs = {}
    dense_tols = {"bfloat16": 0.10, "float32": 1e-3}

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def weights(label, model):
        return _with_gates(_init_weights(torch, label, model), XATTN_GATE)

    try:
        cfg = get_config("whisper-small").replace(decode_impl="kernel")
    except NotImplementedError:        # --breakdown-only on a tree before these configs
        log("[legW1] skipped: this tree has no cross-attention configs")
        return legs
    model = build_model(cfg)
    params = weights("legW1", model)
    src = _leg_sources(torch, cfg, 375)
    n_self, _, n_ckv = _stack(model)
    if breakdown_only:
        _breakdown_only(torch, "legW1", model, params, 64, 64, dev["mem_bps"], src=src)
    else:
        legs["legW1"] = _serve_leg(
            torch, "legW1", model, params, prompt_len=64, steps=64,
            expect=_expect(swiftkv_decode=(n_self + n_ckv) * 64),
            plain_model=build_model(cfg.replace(decode_impl="blockwise")),
            rel_tols=dense_tols, mem_bps=dev["mem_bps"], breakdown=True, src=src)
        legs["legW2"] = _continuous_leg(torch, "legW2", model, params, setup=LEG_W2,
                                        trace_kw=LEG_W2_TRACE, keep=True)
        legs["legT3"] = _ingest_fault_leg(torch, legs["legW2"])
    del params, model, src
    free()

    cfg = get_config("llama-3.2-vision-90b").replace(decode_impl="kernel",
                                                     n_layers=VISION_DEPTH)
    cfg_q = get_config("llama-3.2-vision-90b+w4a8").replace(decode_impl="kernel",
                                                            n_layers=VISION_DEPTH)
    model = build_model(cfg)
    if not _takes_mma(torch, cfg):
        raise AssertionError("legV1: llama-3.2-vision-90b does not take the GQA form")
    params = weights("legV1", model)
    src = _leg_sources(torch, cfg, 400)
    n_self, _, n_ckv = _stack(model)
    if breakdown_only:
        _breakdown_only(torch, "legV1", model, params, 512, 32, dev["mem_bps"], src=src)
        return legs
    steps = 32
    legs["legV1"] = _serve_leg(
        torch, "legV1", model, params, prompt_len=512, steps=steps,
        expect=_expect(swiftkv_decode=(n_self + n_ckv) * steps,
                       swiftkv_decode_mma=(n_self + n_ckv) * steps),
        plain_model=build_model(cfg.replace(decode_impl="blockwise")),
        rel_tols=dense_tols, mem_bps=dev["mem_bps"], breakdown=True, src=src)
    del src
    t0 = time.perf_counter()
    params_q = quantize_params(params)
    torch.cuda.synchronize()
    log(f"[legV2] quantize_params on the card: {time.perf_counter() - t0:.1f} s")
    del params, model
    free()
    legs["legV2"] = _continuous_leg(torch, "legV2", build_model(cfg_q), params_q,
                                    setup=LEG_C, trace_kw=LEG_V2_TRACE)
    del params_q
    free()
    return legs


TRAIN_STEPS = 6              # leg TR1: steps of h2o-danube-1.8b at full size
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# AdamW's first steps move every weight by ~lr * sign(g), a coherent update
# whose norm grows with the width: at base lr 1e-3, 3e-4 and 1e-4 the loss
# of the 24-layer model climbs within 6 steps (10.90 -> 18.34, 12.09,
# 11.30); at 2 layers the reference climbs alike at 1e-3
# (tools/train_lr_probe.py). TR1 takes 5e-5
TRAIN_LR = 5e-5


def _train_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, remat's
    recompute not counted): 6 x the parameters each token meets in a
    product (all but the embedding table, a lookup) x the tokens, plus the
    attention's two products over the keys each query attends under the
    causal window (QK^T and PV, 2 x 2 x Hq x Dh each, x 3 for forward and
    backward)."""
    keys = sum(min(q + 1, cfg.window or seq) for q in range(seq)) / seq
    attn = 3 * 4 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * keys
    return (6 * n_params + attn) * tokens


def _train_step_vs_cpu(torch, cfg, batch: dict) -> None:
    """Leg TR2, check 1: one train step of the reduced config on the card
    against the same step on the CPU, same params and batch: the loss, every
    gradient leaf (the CPU tests' tolerances: 1e-6 relative, 2e-5 of a
    leaf's largest gradient) and the AdamW update (the CPU's update of the
    card's gradients, within 1e-6 of a leaf's largest value: the update
    divides by sqrt(nu), which would magnify a gradient difference near 0)."""
    from repro_torch.models.api import build_model, lm_loss
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import tree_items

    def value_and_grad(dev, params):
        model = build_model(cfg, device=dev)
        return _value_and_grad(lambda p, b: lm_loss(model, p, b["tokens"], b["labels"]),
                               params, {k: v.to(dev) for k, v in batch.items()})

    def worst(got: dict, want: dict) -> float:
        want = dict(tree_items(want))
        return max(float((t.cpu() - want[k]).abs().max()) / max(float(want[k].abs().max()),
                                                                 1e-30)
                   for k, t in tree_items(got))

    params = build_model(cfg, device="cpu").init_params(0)
    loss_cpu, grads_cpu = value_and_grad("cpu", params)
    loss_dev, grads_dev = value_and_grad("cuda", _tree_to(params, "cuda"))
    rel = abs(float(loss_dev) - float(loss_cpu)) / abs(float(loss_cpu))
    grad_err = worst(grads_dev, grads_cpu)
    updated = {}
    for dev in ("cuda", "cpu"):          # both from the card's gradients
        p = _tree_to(params, dev)
        st = adamw_init(p)
        lr = cosine_schedule(st.step, base_lr=1e-3, warmup=2, total=6)
        updated[dev] = adamw_update(p, _tree_to(grads_dev, dev), st, lr=lr)[0]
    upd_err = worst(updated["cuda"], updated["cpu"])
    log(f"[legTR2] {cfg.name} reduced, one train step card vs CPU: loss {float(loss_dev):.6f} "
        f"vs {float(loss_cpu):.6f} (rel {rel:.2e}), worst gradient leaf {grad_err:.2e} of its "
        f"largest, AdamW update {upd_err:.2e} of a leaf's largest value")
    if rel > 1e-6 or grad_err > 2e-5 or upd_err > 1e-6:
        raise AssertionError("legTR2: the card's train step differs from the CPU's")


def _train_loop(model, path, *, steps, ckpt_every, failure_injector=None):
    from repro_torch.train import TrainLoop, make_train_step
    step = make_train_step(model, base_lr=1e-3, warmup=2, total_steps=steps)
    loop = TrainLoop(model, model.cfg, step, seq_len=64, global_batch=4, ckpt_dir=str(path),
                     ckpt_every=ckpt_every, failure_injector=failure_injector)
    return loop.run(steps)


def _train_resume_and_retry(torch, cfg) -> None:
    """Leg TR2, checks 2 and 3, under ``torch.use_deterministic_algorithms``
    (``CUBLAS_WORKSPACE_CONFIG=:4096:8``): a 6-step run checkpointing every
    3 steps against a 3-step run that a new loop resumes to 6 (steps 3-5);
    and a run whose step 4 fails once (restored from step 3, steps 3 and 4
    rerun): every loss bitwise the uninterrupted run's."""
    import os
    import shutil
    from repro_torch.models.api import build_model
    root = ROOT / "build" / "train_legTR2"
    shutil.rmtree(root, ignore_errors=True)
    old_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        model = build_model(cfg)
        clean = [h["loss"] for h in _train_loop(model, root / "clean", steps=6, ckpt_every=3)]
        _train_loop(model, root / "resume", steps=3, ckpt_every=3)
        resumed = _train_loop(model, root / "resume", steps=6, ckpt_every=3)
        armed = {"on": True}

        def fail_once(step):
            if step == 4 and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected failure at step 4")
        retried = _train_loop(model, root / "retry", steps=6, ckpt_every=3,
                              failure_injector=fail_once)
    finally:
        torch.use_deterministic_algorithms(False)
        if old_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_env
        shutil.rmtree(root, ignore_errors=True)
    log(f"[legTR2] losses of 6 steps: {clean}")
    if [h["step"] for h in resumed] != [3, 4, 5] or [h["loss"] for h in resumed] != clean[3:]:
        raise AssertionError(f"legTR2: the resumed run's losses {resumed} differ from "
                             f"{clean[3:]}")
    if [h["step"] for h in retried] != [0, 1, 2, 3, 3, 4, 5] or \
            [h["loss"] for h in retried] != clean[:4] + clean[3:]:
        raise AssertionError(f"legTR2: the retried run's losses {retried} differ")
    log("[legTR2] resume from step 3 and a retry of step 4 (restored from step 3): "
        "losses bitwise the uninterrupted run's (deterministic algorithms)")


def _train_full(torch, dev: dict) -> None:
    """Leg TR1: 6 steps through ``TrainLoop`` from the seeded init, no
    checkpoint; checks and prints (see ``phase_train_legs``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainLoop, make_train_step
    from repro_torch.tree import tree_items
    cfg = get_config("h2o-danube-1.8b")
    model = build_model(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch_ms = []
    for step in range(2):
        t0 = time.perf_counter()
        batch_for_step(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, 0, step, device="cuda")
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[legTR1] one counted batch {TRAIN_BATCH} x {TRAIN_SEQ} at vocab {cfg.vocab_size}: "
        f"{batch_ms[1]:.1f} ms (the first, with warm-up: {batch_ms[0]:.1f} ms)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(model, cfg, make_train_step(model, base_lr=TRAIN_LR, warmup=2,
                                                 total_steps=TRAIN_STEPS),
                     seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, ckpt_dir=None)
    reset_launches()
    t0 = time.perf_counter()
    hist = loop.run(TRAIN_STEPS)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    params = loop._final[0]
    n_all = sum(t.numel() for _, t in tree_items(params))
    n_matmul = n_all - params["embed"].numel()
    del loop, params
    torch.cuda.empty_cache()
    for h in hist:
        log(f"[legTR1] step {h['step']}: loss {h['loss']:.4f} grad_norm {h['grad_norm']:.4f} "
            f"lr {h['lr']:.2e} {h['step_time_s'] * 1e3:.1f} ms")
    losses = [h["loss"] for h in hist]
    if not all(map(math.isfinite, losses + [h["grad_norm"] for h in hist])):
        raise AssertionError("legTR1: a loss or gradient norm is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"legTR1: the last loss {losses[-1]} is not below the first "
                             f"{losses[0]}")
    if any(launches.values()):
        raise AssertionError(f"legTR1: training launched a kernel: {_nonzero(launches)}")
    step_s = statistics.median(h["step_time_s"] for h in hist[1:])
    flops = _train_flops(cfg, n_matmul, tokens, TRAIN_SEQ)
    mfu = flops / step_s / dev["bf16_ops"]
    log(f"[legTR1] {cfg.name}: {n_all / 1e9:.3f} B parameters ({n_matmul / 1e9:.3f} B in "
        f"products), base lr {TRAIN_LR:g}, {TRAIN_STEPS} steps of {tokens} tokens in "
        f"{wall:.1f} s; median step after the first {step_s * 1e3:.1f} ms = "
        f"{tokens / step_s:.0f} tokens/s (first step {hist[0]['step_time_s'] * 1e3:.1f} ms); "
        f"peak memory {peak / 1e9:.2f} GB; model FLOPs {flops / 1e12:.2f} T a step = "
        f"{mfu:.4f} of {dev['bf16_ops'] / 1e12:.0f} TFLOP/s; kernel launches 0")
    return {"losses": losses, "step_ms": step_s * 1e3, "peak_gb": peak / 1e9}


FS1_STEPS = 3
# TR1 indexes the embedding table; FS1's table is a DTensor and goes through
# F.embedding, whose backward sums each token's bf16 gradient rows in float32
# and rounds once. AdamW's first steps (~lr * sign(g)) carry that rounding
# into the next losses (FS1 prints how far). Step 0's loss (forward only)
# must be bitwise.
FS1_LOSS_RTOL = 1e-4


def _train_sharded(torch, tr1: dict) -> list[float]:
    """Leg FS1: TR1's setup (h2o-danube-1.8b at full size, seed 0, the
    counted 8 x 1024 batches of steps 0-2, base lr TRAIN_LR, warmup 2 of
    TRAIN_STEPS, remat "full") through ``make_train_step(param_specs=)``
    on ``DTensor`` s: params and AdamW state from ``shard_train_state``
    over the one-rank world's (1, 1) mesh, each batch placed by
    ``batch_specs`` (data on dim 0). Each step's time takes in its counted
    batch, as TrainLoop's does for TR1. On one rank every redistribute
    moves nothing and the local ops are TR1's but for the embedding's
    backward (FS1_LOSS_RTOL)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.distributed.sharding import device_put, named
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import shard_train_state
    from repro_torch.models.api import build_model
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_items
    cfg = get_config("h2o-danube-1.8b")
    with _one_rank_world(torch, "legFS1") as ctx:
        mesh = ctx.mesh
        model = build_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, specs = shard_train_state(model, mesh, seed=0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        step = make_train_step(model, base_lr=TRAIN_LR, warmup=2, total_steps=TRAIN_STEPS,
                               param_specs=specs)
        batch_specs = {"tokens": ("data", None), "labels": ("data", None)}
        losses, times = [], []
        reset_launches()
        for i in range(FS1_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = device_put(batch_for_step(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, 0, i,
                                              device="cuda"), batch_specs, mesh)
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = {k: tuple(pl) for k, pl in tree_items(named(specs, mesh))}
        misplaced = [k for tree in (params, opt.mu, opt.nu) for k, t in tree_items(tree)
                     if tuple(t.placements) != want[k]]
        del params, opt, step
    torch.cuda.empty_cache()
    ref = tr1["losses"][:FS1_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    step_ms = statistics.median(times[1:]) * 1e3
    log(f"[legFS1] {cfg.name} sharded step on DTensors, mesh (1, 1): params and AdamW state "
        f"placed in {setup_s:.1f} s; losses {losses} against TR1's {ref} on the same "
        f"batches: {'bitwise' if losses == ref else f'{rel:.2e} relative'}; steps "
        f"{[round(t * 1e3, 1) for t in times]} ms, median after the first {step_ms:.1f} ms "
        f"(TR1's {tr1['step_ms']:.1f} ms); peak memory {peak / 1e9:.2f} GB (TR1's "
        f"{tr1['peak_gb']:.2f} GB); kernel launches {sum(launches.values())}")
    if rel > FS1_LOSS_RTOL or losses[0] != ref[0]:
        raise AssertionError(f"legFS1: the sharded step's losses {losses} differ from TR1's "
                             f"{ref} by {rel:.2e} relative")
    if misplaced:
        raise AssertionError(f"legFS1: leaves left their specs' placements: {misplaced[:5]}")
    if any(launches.values()):
        raise AssertionError(f"legFS1: training launched a kernel: {_nonzero(launches)}")
    return losses


# the dry run's cells: (arch, shape, its flags)
DRYRUN_CELLS = (("qwen3-8b", "decode_32k", "--cost"),
                ("whisper-small", "train_4k", "--multi-pod", "--reduced"))
DRYRUN_TIMEOUT = 300


def phase_dryrun() -> None:
    """Phase dryrun: each cell ``python -m repro_torch.launch.dryrun`` in a
    subprocess of its own, all started at once, after every leg (so they
    share the host with no timed work); one line a cell. A cell that is not
    ``ok``, or whose process fails or outlives DRYRUN_TIMEOUT, fails the
    script."""
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    started = []
    try:
        for arch, shape, *flags in DRYRUN_CELLS:
            out = out_dir / f"{arch}__{shape}.json"
            out.unlink(missing_ok=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, *flags, "--json", str(out)]
            with open(out.with_suffix(".log"), "w") as f:     # the child keeps its own copy
                started.append((arch, shape, out, subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)))
        for arch, shape, out, proc in started:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
            secs = time.perf_counter() - t0
            err = out.with_suffix(".log").read_text()[-2000:]
            rep = json.loads(out.read_text()) if out.exists() else {"ok": False, "error": err}
            if proc.returncode or not rep["ok"]:
                raise AssertionError(f"dryrun: {arch} {shape}: {rep.get('error', err)}")
            r = rep["roofline"]
            log(f"[dryrun] {arch} {shape} ({rep['mesh']} {rep['mode']}): ok, done {secs:.1f} s "
                f"after the phase's start (its run {rep['run_s']} s): t_compute "
                f"{r['t_compute_ms']:.3f} ms, t_memory {r['t_memory_ms']:.3f} ms, t_collective "
                f"{r['t_collective_ms']:.3f} ms ({r['dominant']}), useful "
                f"{r['useful_frac']:.4f}; collectives {r['op_counts']}; a model on the H100 "
                f"constants, not a measurement")
    finally:
        for *_, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[dryrun] phase done in {time.perf_counter() - t0:.1f} s")


# the examples as phase examples runs them: (example, its arguments; the
# device is the card). train_lm runs at its default size (7.3M params, 200
# steps) and at the size its docstring names (d_model 512, 12 layers:
# 46.1M params), 50 steps.
EXAMPLE_RUNS = (("torch_quickstart", ()),
                ("torch_serve_decode", ()),
                ("torch_serve_continuous", ()),
                ("torch_train_lm", ()),
                ("torch_train_lm", ("--d-model", "512", "--layers", "12", "--steps", "50")),
                ("torch_multi_arch_smoke", ()))
EXAMPLES_BUDGET_S = 60.0


def _load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_example(torch, name: str, res: dict, launches: dict) -> str:
    """The checks of one example's ``main`` beside its own assertions; a
    summary of what it printed."""
    decode = sum(v for k, v in launches.items() if k.startswith("swiftkv_decode")
                 and k != "swiftkv_decode_mma")
    if name == "torch_quickstart":
        errs = {k: res[k] for k in ("tokenwise", "blockwise", "kernel", "merged")}
        if not (max(errs.values()) <= 1e-5 and decode >= 1):
            raise AssertionError(f"examples: quickstart errors {errs}, decode launches {decode}")
        return (f"errors {errs}, LUT {res['lut_max_rel_err']:.3e}, Q15.17 "
                f"{res['fxp_mean_abs_err']:.2e}, decode kernel launches {decode}")
    if name == "torch_serve_decode":
        kern = res["launches"]["kernel"]
        others = {k: v for k, v in res["launches"].items() if k != "kernel"}
        if kern < 1 or any(others.values()):
            raise AssertionError(f"examples: serve_decode launches {res['launches']}")
        rates = ", ".join(f"{k} {v:.1f}" for k, v in res["tokens_per_s"].items())
        return (f"tok/s {rates}; decode kernel launches in the kernel impl's run {kern} "
                f"(all runs {decode}); RoPE modes equal {res['rope_same']}")
    if name == "torch_serve_continuous":
        agg = res["aggregate"]
        if not (res["same"] and agg["n_retired"] == 8):
            raise AssertionError(f"examples: serve_continuous {agg}")
        return (f"{agg['n_retired']} requests, {agg['generated_tokens']} tokens, "
                f"{agg['tokens_per_s']} tok/s, {agg['host_syncs']} host syncs")
    if name == "torch_train_lm":
        losses = res["losses"]
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"examples: train_lm losses {losses}")
        steps = [h["step_time_s"] for h in res["history"][1:]]
        return (f"{res['params'] / 1e6:.1f}M params, {len(losses)} steps (one injected "
                f"failure, then a restore), loss {losses[0]:.4f} -> {losses[-1]:.4f}, median step "
                f"{statistics.median(steps) * 1e3:.1f} ms")
    bad = {a: r["loss"] for a, r in res.items()
           if not (math.isfinite(r["loss"]) and r["tokens"].shape == (2, 4))}
    if len(res) != 10 or bad:
        raise AssertionError(f"examples: multi_arch_smoke ran {list(res)}, bad {bad}")
    return "losses " + ", ".join(f"{a} {r['loss']:.3f}" for a, r in res.items())


def _check_linear_w4a8(torch) -> None:
    """``linear_w4a8`` (bf16 x, a bf16 bias, K 4096 -> N 4096) at M 1 (the
    decode form) and M 64 (the prefill form) against its plain version on
    the same card tensors, within the GEMV tolerance; each launch counted."""
    from repro_torch.core.quantization import quantize_w4
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops
    from repro_torch.kernels.gemv_w4a8 import ref as gemv_ref
    gen = torch.Generator(device="cuda").manual_seed(30)
    qw = quantize_w4(torch.randn(4096, 4096, generator=gen, device="cuda") * 0.02)
    qw = qw._replace(bias=torch.randn(4096, generator=gen, device="cuda").to(torch.bfloat16))
    for m, want_launches in ((1, {"gemv_w4a8_decode": 1}),
                             (64, {"gemv_w4a8_quant": 1, "gemv_w4a8": 1})):
        x = torch.randn(m, 4096, generator=gen, device="cuda").to(torch.bfloat16)
        reset_launches()
        got = gemv_ops.linear_w4a8(x, qw)
        launches = _nonzero(dict(LAUNCHES))
        plain = gemv_ref.gemv_w4a8_ref(x, qw.packed, qw.scale) + qw.bias
        torch.cuda.synchronize()
        err, tol = _gemv_err(torch, got, plain)
        log(f"[examples] linear_w4a8 M={m} K=4096 N=4096 bf16 + bias: max_abs_err {err:.3g} "
            f"(tol {tol:.3g}) of its plain version, launches {launches}")
        if not (got.dtype == torch.float32 and torch.isfinite(got).all().item()
                and err <= tol and launches == want_launches):
            raise AssertionError(f"examples: linear_w4a8 M={m}: err {err} > {tol} or "
                                 f"launches {launches}")


def phase_examples(torch) -> None:
    """Phase examples: each ``examples/torch_*.py`` ``main`` on the card at
    its defaults (:data:`EXAMPLE_RUNS`), checked by :func:`_check_example`
    beside its own assertions. While it runs, the decode kernel's plain
    version (``ref.swiftkv_decode_ref``) counts its calls, which must stay
    0 (no fallback from the kernel); the kernels' launches are counted per
    example (apart from the legs' sums). Then ``linear_w4a8`` against its plain version. One line an
    example; the phase's budget is EXAMPLES_BUDGET_S."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.swiftkv_decode import ops as kops
    t_phase = time.perf_counter()
    plain_calls = [0]
    real_plain = kops.ref.swiftkv_decode_ref

    def counted_plain(*args, **kw):
        plain_calls[0] += 1
        return real_plain(*args, **kw)

    ckpt = ROOT / "build" / "examples"
    with _swapped(kops.ref, "swiftkv_decode_ref", counted_plain):
        for i, (name, args) in enumerate(EXAMPLE_RUNS):
            argv = list(args)
            if name == "torch_train_lm":          # a fresh directory: no resume
                shutil.rmtree(ckpt / f"train_lm_{i}", ignore_errors=True)
                argv += ["--ckpt-dir", str(ckpt / f"train_lm_{i}")]
            reset_launches()
            t0 = time.perf_counter()
            res = _load_example(name).main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _nonzero(dict(LAUNCHES))
            summary = _check_example(torch, name, res, launches)
            if plain_calls[0]:
                raise AssertionError(f"examples: {name} called the decode kernel's plain "
                                     f"version {plain_calls[0]} times")
            log(f"[examples] {name}{' ' + ' '.join(args) if args else ''} {secs:.1f} s: "
                f"{summary}; launches {launches}; plain decode calls {plain_calls[0]}")
    shutil.rmtree(ckpt, ignore_errors=True)
    _check_linear_w4a8(torch)
    secs = time.perf_counter() - t_phase
    log(f"[examples] phase done in {secs:.1f} s (budget {EXAMPLES_BUDGET_S:.0f} s"
        f"{'' if secs <= EXAMPLES_BUDGET_S else ', OVER'})")


def log_digests(legs: dict, train: dict) -> None:
    """One line of sha256 digests of the tokens of legs A, C1 and M1 and of
    TR1's and FS1's losses, so two trees' runs can be held to each other."""
    import hashlib
    digest = lambda x: hashlib.sha256(json.dumps(x, sort_keys=True).encode()).hexdigest()[:16]
    parts = {"legA": legs["legA"]["tokens"].tolist(),
             "legC1": {str(k): [int(t) for t in v] for k, v in legs["legC1"]["tokens"].items()},
             "legM1": legs["legM1"]["tokens"].tolist(),
             "legTR1": train["legTR1"], "legFS1": train["legFS1"]}
    log("[digests] " + "; ".join(f"{k} {digest(v)}" for k, v in parts.items())
        + f"; TR1 losses {train['legTR1']}; FS1 losses {train['legFS1']}")


def phase_train_legs(torch, dev: dict) -> dict:
    """Training (after the serving legs). TR2: the reduced h2o-danube-1.8b
    (float32) on the card: one train step against the CPU's, then resume and
    retry. TR1: h2o-danube-1.8b at full size (24 layers, d 2560, 32/8 heads
    of 80, d_ff 6912, vocab 32000, window 4096): float32 master weights
    from the seeded init, bf16 compute, remat "full", global batch 8 x 1024
    from the counted pipeline (seed 0), ``make_train_step(base_lr=TRAIN_LR,
    warmup=2, total_steps=6)``, 6 steps through ``TrainLoop`` with no
    checkpoint (one is ~29 GB at this size). Every loss and gradient norm
    finite, the last loss below the first, no launch of either kernel
    (training runs none); prints tokens/s, the median step after the first,
    the peak memory and the model-FLOP share against the card's dense bf16
    peak. FS1: TR1's first 3 steps again through the sharded step
    (:func:`_train_sharded`)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    t0 = time.perf_counter()
    reduced = get_config("h2o-danube-1.8b", reduced=True)
    reset_launches()
    _train_step_vs_cpu(torch, reduced, batch_for_step(reduced.vocab_size, 64, 4, 0, 0))
    _train_resume_and_retry(torch, reduced)
    if any(LAUNCHES.values()):
        raise AssertionError(f"legTR2: training launched a kernel: {_nonzero(dict(LAUNCHES))}")
    log(f"[legTR2] done in {time.perf_counter() - t0:.1f} s; kernel launches 0")
    tr1 = _train_full(torch, dev)
    fs1 = _train_sharded(torch, tr1)
    log(f"[train] phase done in {time.perf_counter() - t0:.1f} s")
    return {"legTR1": tr1["losses"], "legFS1": fs1}


def phase_timings(torch, dev: dict, legs: dict) -> list[dict]:
    """Kernel, plain version and library call at the serving path's shapes,
    beside the bound: max(bytes moved / memory rate, operations / peak)."""
    import torch.nn.functional as F
    from repro_torch.core.quantization import GROUP, quantize_w4, unpack_w4
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops, ref as gemv_ref
    from repro_torch.kernels.swiftkv_decode import ops as skv_ops, ref as skv_ref
    t_phase = time.perf_counter()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    instances = set()

    def occupancy_line(q, k, kw, form):
        """One line per kernel instance timed: the card's occupancy of it,
        which the split policy reads (``ops.occupancy``)."""
        g, d = q.shape[1] // k.shape[2], q.shape[2]
        scale = kw.get("k_scale")
        key = (form, g, d, q.dtype, k.dtype, None if scale is None else scale.dtype,
               kw.get("exp_mode") == "lut")
        if key not in instances:
            instances.add(key)
            ctas, clusters = skv_ops.occupancy(*key)
            log(f"[time] swiftkv_decode instance: {form} form, G {g}, D {d}, q {key[3]}, "
                f"cache {key[4]}" + (f", scales {key[5]}" if scale is not None else "")
                + (", LUT" if key[6] else "") + f": {ctas} CTAs per SM; resident clusters "
                f"of n = 1..8 CTAs {list(clusters)}")

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

    def swiftkv(b, hq, hkv, s, d, length, int8, window=None, ring=False, lut=False):
        q, k, v, lens, kw = _swiftkv_inputs(torch, gen, b, hq, hkv, s, d, torch.bfloat16,
                                            int8=int8, lengths=[length] * b)
        kw.update(window=window, ring=ring)
        if lut:
            kw["exp_mode"] = "lut"
        kern = lambda: skv_ops.swiftkv_decode(q, k, v, lens, **kw)
        plain = lambda: skv_ref.swiftkv_decode_ref(q, k, v, lens, **kw)
        err = (kern().float() - plain().float()).abs().max().item()
        ms, plain_ms = timer(kern), timer(plain)
        form, n_split, _ = _skv_plan(torch, q, k, window, kw.get("k_scale"))
        if lut:
            form, n_split = "fold", skv_ops.split_plan(q, k, window, k_scale=kw.get("k_scale"),
                                                       exp_mode="lut")
        occupancy_line(q, k, kw, form)
        fold_ms = None                 # the earlier kernel on the same call
        if form == "mma":
            fold_ms = timer(lambda: skv_ops.launch(q, k, v, lens, form="fold", **kw))
        library_ms, library_form = None, ("none: no PyTorch call takes the LUT exponential"
                                          if lut else None)
        # the positions that attend: the window's, on a ring its R slots'
        n_pos = length if ring else min(length, s)
        if window:
            n_pos = min(n_pos, window, s if ring else n_pos)
        if not (int8 or lut):     # one library call computes the same function
            g = hq // hkv
            t = torch.arange(s, device="cuda")[None]
            if ring:     # the slots' positions, and the window over them
                p = lens[:, None] - 1
                pos = p - torch.remainder(p - t, s)
                mask = (pos >= 0) & (pos > p - window)
            else:
                mask = (t < lens[:, None]) & (t >= lens[:, None] - (window or s))
            mask = mask[:, None, None, :]
            kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))   # [B, Hkv, S, D]
            sdpa = lambda kk, vv, **kw: F.scaled_dot_product_attention(
                q[:, :, None, :], kk, vv, attn_mask=mask, **kw)
            library_form = "head-major copy of the cache" + (
                ", the ring's window as a boolean mask" if ring
                else ", the window as a boolean mask" if window else "")
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
        kv_rows = b * n_pos * hkv                  # (row, KV head, position) read
        nbytes = (2 * kv_rows * d * k.element_size() + (2 * kv_rows * 2 if int8 else 0)
                  + 2 * q.numel() * q.element_size() + 4 * b)
        bound_ms, bound_by = bound(nbytes, 4 * b * n_pos * hq * d,
                                   dev["int8_ops"] if int8 else dev["bf16_ops"])
        sweep = {}
        for ns in range(1, skv_ops.MAX_SPLIT + 1):   # the wrapper's choice vs the others
            if not lut:
                sweep[ns] = timer(lambda ns=ns: skv_ops.launch(q, k, v, lens, n_split=ns,
                                                               **kw))
        if not (int8 or lut) and (hq == hkv or ring):
            calibrate(nbytes)
        name = ("_lut" if lut else "") + ("_ring" if ring else "") + ("_int8" if int8 else "")
        shape = (f"B={b} Hq={hq} Hkv={hkv} {'R' if ring else 'S'}={s} D={d} len={length} "
                 + (f"window={window} " if window else "")
                 + f"{'int8+bf16 scales' if int8 else 'bf16'}")
        log(f"[time] swiftkv_decode{name} {shape}: kernel {ms:.4f} ms "
            f"({form} form, n_split {n_split}"
            + (f"; the fold on the same call {fold_ms:.4f} ms" if fold_ms else "")
            + f"), plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms if library_ms is None else round(library_ms, 4)} ms "
            f"({library_form}), bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
            f"max_abs_err {err:.3g}")
        row = {"shape": shape, "form": form, "n_split": n_split, "max_abs_err": err,
               "ms": ms, "fold_ms": fold_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms, "library_form": library_form}
        if sweep:      # the policy's pick and the earlier policy's, read from the sweep
            best = min(sweep, key=sweep.get)
            old = _earlier_split(form, b, hkv, s, window, sm_count)
            row.update(sweep_best=best, sweep_ratio=sweep[n_split] / sweep[best],
                       earlier_n_split=old, earlier_ratio=sweep[old] / sweep[best])
            log(f"[time]   by n_split: " + ", ".join(f"{ns}: {t:.4f}" for ns, t in sweep.items())
                + f"; best {best}; the policy's {n_split} at {row['sweep_ratio']:.3f}x the "
                f"best, the earlier policy's {old} at {row['earlier_ratio']:.3f}x")
        return row

    def swiftkv_pooled(b, e, hq, hkv, s, d, int8):
        """The pooled form (``entries=``) at a cross read's shape: B rows,
        each on its own entry of an E-entry pool, whole sources of S rows;
        the library call is SDPA over an ``index_select`` copy of the rows'
        entries, the copy included (it is what the pooled read avoids)."""
        q, k, v, _, kw = _swiftkv_inputs(torch, gen, e, hq, hkv, s, d, torch.bfloat16,
                                         int8=int8, lengths=[s] * e)
        q = q[:b].contiguous()
        entries = torch.arange(0, e, e // b, dtype=torch.int32, device="cuda")[:b]
        idx = entries.long()
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        kern = lambda: skv_ops.swiftkv_decode(q, k, v, lens, entries=entries, **kw)
        plain = lambda: skv_ref.swiftkv_decode_ref(q, k, v, lens, entries=entries, **kw)
        err = (kern().float() - plain().float()).abs().max().item()
        ms, plain_ms = timer(kern), timer(plain)
        form, n_split, _ = _skv_plan(torch, q, k, None, kw.get("k_scale"))
        occupancy_line(q, k, kw, form)
        library_ms, library_form = None, None
        if not int8:
            g = hq // hkv
            library_form = "index_select copy of the entries, head-major, included"

            def library():
                kk = k.index_select(0, idx).transpose(1, 2)
                vv = v.index_select(0, idx).transpose(1, 2)
                if g == 1:
                    return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv)
                return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv,
                                                      enable_gqa=True)
            library()
            library_ms = timer(library)
        rows = b * s * hkv                          # (row, KV head, position) read
        nbytes = (2 * rows * d * k.element_size() + (2 * rows * 2 if int8 else 0)
                  + 2 * q.numel() * q.element_size() + 8 * b)
        bound_ms, bound_by = bound(nbytes, 4 * b * s * hq * d,
                                   dev["int8_ops"] if int8 else dev["bf16_ops"])
        shape = (f"pooled B={b} E={e} Hq={hq} Hkv={hkv} S={s} D={d} len={s} "
                 f"{'int8+bf16 scales' if int8 else 'bf16'}")
        log(f"[time] swiftkv_decode_pooled{'_int8' if int8 else ''} {shape}: kernel {ms:.4f} ms "
            f"({form} form, n_split {n_split}), plain {plain_ms:.4f} ms, sdpa "
            f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
            f"({library_form}), bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
            f"max_abs_err {err:.3g}")
        return {"shape": shape, "form": form, "n_split": n_split, "max_abs_err": err,
                "ms": ms, "fold_ms": None, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "library_form": library_form}

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
        w = unpack_w4(qw.packed).float() * qw.scale.repeat_interleave(GROUP, dim=0)[:k_dim]
        w = w.to(torch.bfloat16)
        dense_ms = timer(lambda: x @ w)
        nbytes = (x.numel() * x.element_size() + qw.packed.numel() + 4 * qw.scale.numel()
                  + 4 * m * n)
        bound_ms, bound_by = bound(nbytes, 2 * m * k_dim * n, dev["int8_ops"])
        row = {"shape": f"M={m} K={k_dim} N={n}", "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "dense_bf16_ms": dense_ms}
        form = ""
        if m <= gemv_ops.DECODE_MAX_M:
            tile_bytes, ks = gemv_ops.decode_plan(m, k_dim, n, sm_count)
            row.update(tile_bytes=tile_bytes, ks=ks, read_flush_ms=timer(kern, flush="read"),
                       stream_ms=back_to_back(x, qw))
            form = (f" (decode form, tile {tile_bytes} B, ks {ks}; "
                    f"{row['read_flush_ms']:.4f} ms with a read flush, "
                    f"{row['stream_ms']:.4f} ms a call back to back)")
        else:
            # the two kernels alone, and a second yardstick that is not the
            # same function either: int8 x int8 -> int32 of the same shape
            codes, scales = gemv_ops.launch_quant(x)
            grid = gemv_ops.prefill_plan(m, n)
            row.update(ctas=grid[0] * grid[1], quant_ms=timer(lambda: gemv_ops.launch_quant(x)),
                       gemm_ms=timer(lambda: gemv_ops.launch_gemm(codes, scales, qw.packed,
                                                                   qw.scale, k_dim)),
                       int_mm_ms=None)
            try:
                xq8 = torch.randint(-127, 128, (m, k_dim), dtype=torch.int8, device="cuda")
                wq8 = torch.randint(-8, 8, (k_dim, n), dtype=torch.int8, device="cuda")
                torch._int_mm(xq8, wq8)
                row["int_mm_ms"] = timer(lambda: torch._int_mm(xq8, wq8))
            except (RuntimeError, AttributeError) as exc:
                log(f"[time]   torch._int_mm at M={m} K={k_dim} N={n}: not timed ({exc})")
            int_mm = "not timed" if row["int_mm_ms"] is None else f"{row['int_mm_ms']:.4f} ms"
            form = (f" (prefill form, {row['ctas']} CTAs: quantize {row['quant_ms']:.4f} "
                    f"+ GEMM {row['gemm_ms']:.4f} ms; torch._int_mm int8 [M, K] x [K, N] "
                    f"(not the same function) {int_mm})")
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

    def quant(m, k_dim):
        """The prefill form's quantize kernel alone, bf16 x: bound by bytes
        (x read, codes and scales written)."""
        from repro_torch.core.quantization import quantize_a8
        x = _rand(torch, gen, m, k_dim, dtype=torch.bfloat16)
        codes, scales = gemv_ops.launch_quant(x)
        q, s = quantize_a8(x)
        same = torch.equal(codes, gemv_ref.pack_codes(q)) and torch.equal(scales, s[:, 0])
        ms = timer(lambda: gemv_ops.launch_quant(x))
        plain_ms = timer(lambda: gemv_ref.pack_codes(quantize_a8(x)[0]))
        nbytes = x.numel() * x.element_size() + codes.numel() + 4 * m
        bound_ms, bound_by = bound(nbytes, 0, dev["int8_ops"])
        log(f"[time] gemv_w4a8_quant M={m} K={k_dim} bf16: kernel {ms:.4f} ms, plain "
            f"(quantize_a8 + pack_codes) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {nbytes / 1e6:.1f} MB), codes and scales equal {same}")
        if not same:
            raise AssertionError("gemv_w4a8_quant: codes or scales differ from quantize_a8's")
        return {"shape": f"M={m} K={k_dim} bf16", "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}

    # leg A decodes lengths 513..576 in a 640-slot cache; leg B 129..192 in 256
    skv_a = swiftkv(8, 32, 32, 640, 128, 576, int8=False)
    skv_b = swiftkv(8, 32, 32, 256, 128, 192, int8=True)
    skv_b576 = swiftkv(8, 32, 32, 640, 128, 576, int8=True)   # int8 at leg A's length
    skv_gqa = swiftkv(8, 32, 8, 640, 128, 576, int8=False)    # qwen3-8b GQA 32/8
    skv_mqa = swiftkv(8, 8, 1, 640, 256, 576, int8=False)     # gemma-2b, leg I
    # leg D's decode step: a 4224-slot ring wrapped once (lengths 4161-4288),
    # window 4096, and the linear windowed form on leg D1's twin's cache
    skv_ring = swiftkv(8, 32, 8, 4224, 80, 4250, int8=False, window=4096, ring=True)
    skv_ring8 = swiftkv(8, 32, 8, 4224, 80, 4250, int8=True, window=4096, ring=True)
    skv_win80 = swiftkv(8, 32, 8, 4352, 80, 4250, int8=False, window=4096)
    # hymba-1.5b's decode step (legs K1, K2): 25 heads of 64 on 5 KV heads, a
    # 1152-slot ring wrapped (lengths 1089-1216), window 1024
    skv_hymba = swiftkv(8, 25, 5, 1152, 64, 1180, int8=False, window=1024, ring=True)
    skv_hymba8 = swiftkv(8, 25, 5, 1152, 64, 1180, int8=True, window=1024, ring=True)
    # the LUT form (exp_mode="lut") at the native rows' shapes; the same bound
    skv_lut = {name: swiftkv(*shape, lut=True, **kw) for name, shape, kw in (
        ("swiftkv_decode_lut", (8, 32, 32, 640, 128, 576), {"int8": False}),
        ("swiftkv_decode_lut_int8", (8, 32, 32, 256, 128, 192), {"int8": True}),
        ("swiftkv_decode_lut_ring", (8, 32, 8, 4224, 80, 4250),
         {"int8": False, "window": 4096, "ring": True}),
        ("swiftkv_decode_lut_ring_int8", (8, 32, 8, 4224, 80, 4250),
         {"int8": True, "window": 4096, "ring": True}))}
    gemv_rows = {}
    decode_shapes = ((4096, 4096), (4096, 11008), (11008, 4096))
    for k_dim, n in decode_shapes:                       # leg B's decode step, M = batch
        gemv_rows[(8, k_dim, n)] = gemv(8, k_dim, n, sweep=True)
    gemv_rows[(8, 4096, 1024)] = gemv(8, 4096, 1024, sweep=True)   # qwen3-8b's K/V
    for k_dim, n in decode_shapes:                       # leg B's prefill, 8 x 128 rows
        gemv_rows[(1024, k_dim, n)] = gemv(1024, k_dim, n)
    gemv_rows[(16, 4096, 4096)] = gemv(16, 4096, 4096)   # a short prefill
    # chatglm-6b's MLP (leg G2): d_ff 16384, decode step and prefill
    chatglm_shapes = ((4096, 16384), (16384, 4096))
    for m in (8, 1024):
        for k_dim, n in chatglm_shapes:
            gemv_rows[(m, k_dim, n)] = gemv(m, k_dim, n)
    # hymba-1.5b's (legs K2) and rwkv6-3b's (leg R2) projections, decode and prefill
    for m in (8, 1024):
        for k_dim, n in RECURRENT_GEMV_SHAPES:
            gemv_rows[(m, k_dim, n)] = gemv(m, k_dim, n)
    quant_row = quant(1024, 11008)
    # the cross reads (legs W1, W2, V1, V2): per-row at whisper-small's and
    # llama-3.2-vision's whole sources, and the pooled form (entries=)
    skv_w1 = swiftkv(8, 12, 12, 1500, 64, 1500, int8=False)
    skv_v1 = swiftkv(8, 64, 8, 1600, 128, 1600, int8=False)
    skv_w2 = swiftkv_pooled(8, 16, 12, 12, 1500, 64, int8=False)
    skv_v2 = swiftkv_pooled(8, 16, 64, 8, 1600, 128, int8=True)
    skv_v2_bf16 = swiftkv_pooled(8, 16, 64, 8, 1600, 128, int8=False)
    # llama-3.2-vision-90b+w4a8's projections (leg V2): decode step and prefill
    for m in (8, 1024):
        for k_dim, n in VISION_GEMV_SHAPES:
            gemv_rows[(m, k_dim, n)] = gemv(m, k_dim, n)
    swept = [skv_a, skv_b, skv_b576, skv_gqa, skv_mqa, skv_ring, skv_ring8, skv_win80,
             skv_hymba, skv_hymba8, skv_w1, skv_v1]
    worst = max(swept, key=lambda r: r["sweep_ratio"])
    log(f"[time] split policy at the {len(swept)} swept decode rows: its pick within 1.07x of "
        f"the sweep's best at {sum(r['sweep_ratio'] <= 1.07 for r in swept)} (the earlier "
        f"policies' at {sum(r['earlier_ratio'] <= 1.07 for r in swept)}), the best at "
        f"{sum(r['n_split'] == r['sweep_best'] for r in swept)}; worst "
        f"{worst['sweep_ratio']:.3f}x at {worst['shape']}; kernel vs SDPA: "
        + ", ".join(f"{r['shape']} {r['ms']:.4f} vs {r['library_ms']:.4f} ms"
                    for r in (skv_mqa, skv_w1, skv_v1)))

    def launches(name, form=None):
        """The kernel's launches summed over the serving runs (legs A-M,
        K, L, R, S, SP1), each counted from 0 around its own run (EP1,
        which repeats M1's decode, has no count here); ``form="fold"``
        counts only the legs whose attention took the fold (a leg's decode
        attention takes one form, and the GQA form's launches also count
        under their ``swiftkv_decode*`` key)."""
        return sum(leg["launches"][name] for leg in legs.values() if "launches" in leg
                   and (form is None
                        or (form == "fold") == (not leg["launches"]["swiftkv_decode_mma"])))

    csrc = "src/repro_torch/csrc/"
    # launches: the serving runs' count of the kernel that computed the row
    # (the fold's by its form's key, the GQA form's by swiftkv_decode_mma);
    # the rows at the int8 len 576 and GQA 32/8 shapes time them off the path
    fold = {"route": "cuda", "source": csrc + "swiftkv_decode.cu",
            "replaces": "src/repro/kernels/swiftkv_decode/kernel.py:140"}
    mma = {**fold, "source": csrc + "swiftkv_decode_mma.cu"}
    n_mma = launches("swiftkv_decode_mma")

    def skv_row(key, row):
        if key.startswith("swiftkv_decode_pooled"):     # the pooled calls by their own key
            return {"name": key, **(mma if row["form"] == "mma" else fold),
                    "launches": launches(key, row["form"]), **row}
        if row["form"] == "mma":
            return {"name": "swiftkv_decode_mma", **mma, "launches": n_mma, **row}
        return {"name": key, **fold, "launches": launches(key, "fold"), **row}

    rows = [skv_row("swiftkv_decode", skv_a), skv_row("swiftkv_decode_int8", skv_b),
            skv_row("swiftkv_decode_int8", skv_b576), skv_row("swiftkv_decode", skv_gqa),
            skv_row("swiftkv_decode", skv_mqa),
            skv_row("swiftkv_decode_ring", skv_ring), skv_row("swiftkv_decode_ring_int8", skv_ring8),
            skv_row("swiftkv_decode", skv_win80),
            skv_row("swiftkv_decode_ring", skv_hymba),
            skv_row("swiftkv_decode_ring_int8", skv_hymba8)]
    # the LUT form: no serving path takes it (the reference reaches it only
    # through the kernel's own entry point), so its launches there are 0
    rows += [skv_row(name, row) for name, row in skv_lut.items()]
    rows += [skv_row("swiftkv_decode", skv_w1), skv_row("swiftkv_decode", skv_v1),
             skv_row("swiftkv_decode_pooled", skv_w2),
             skv_row("swiftkv_decode_pooled_int8", skv_v2),
             skv_row("swiftkv_decode_pooled", skv_v2_bf16)]
    gemv_src = {"route": "cuda", "source": csrc + "gemv_w4a8.cu",
                "replaces": "src/repro/kernels/gemv_w4a8/kernel.py:66"}
    n_dec = launches("gemv_w4a8_decode")
    rows += [{"name": "gemv_w4a8_decode", **gemv_src, "launches": n_dec,
              **gemv_rows[(8, k, n)]}
             for k, n in decode_shapes + ((4096, 1024),) + chatglm_shapes + RECURRENT_GEMV_SHAPES
             + VISION_GEMV_SHAPES]
    n_pre = launches("gemv_w4a8")
    rows += [{"name": "gemv_w4a8", **gemv_src, "launches": n_pre, **gemv_rows[key]}
             for key in ((1024, 4096, 4096), (1024, 4096, 11008), (1024, 11008, 4096),
                         (16, 4096, 4096))
             + tuple((1024, k, n) for k, n in chatglm_shapes + RECURRENT_GEMV_SHAPES
                     + VISION_GEMV_SHAPES)]
    rows += [{"name": "gemv_w4a8_quant", **gemv_src,
              "launches": launches("gemv_w4a8_quant"), **quant_row}]
    log(f"[time] phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="also break each leg's decode step down (eager vs CUDA-graph "
                         "replay vs profiler kernel time and count, and its bytes bound)")
    ap.add_argument("--breakdown-only", action="store_true",
                    help="build the kernels, time one prefill per leg and break each "
                         "leg's decode step down, with no check, serving run or kernel "
                         "timing (a before/after of two trees)")
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
    leg_phases = (phase_legs, phase_ring_legs, phase_family_legs, phase_recurrent_legs,
                  phase_xattn_legs)
    if args.breakdown_only:
        for phase in leg_phases:
            phase(torch, dev, True, breakdown_only=True)
            torch.cuda.empty_cache()
        log(f"[done] breakdown only, in {time.perf_counter() - t_start:.1f} s")
        return 0
    for phase in (phase_kernel_checks, phase_reduced_models):
        t_phase = time.perf_counter()
        phase(torch)
        log(f"[{phase.__name__}] done in {time.perf_counter() - t_phase:.1f} s")
    legs = {}
    for phase in leg_phases:
        t_phase = time.perf_counter()
        legs.update(phase(torch, dev, args.breakdown))
        torch.cuda.empty_cache()
        log(f"[{phase.__name__}] done in {time.perf_counter() - t_phase:.1f} s")
    train = phase_train_legs(torch, dev)
    torch.cuda.empty_cache()
    rows = phase_timings(torch, dev, legs)
    log_digests(legs, train)
    phase_dryrun()
    phase_examples(torch)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
