"""Serving entry point: prefill + per-token decode (the paper's workload).
Port of ``repro.launch.serve``, two modes:

* **lock-step** (default): ``ServingEngine``, uniform-length prompts,
  prefill once, decode in lock-step;
* **continuous** (``--continuous``): ``ContinuousBatchingEngine`` over a
  Poisson or file trace (slot pool, scheduler, chunked slot prefill,
  multi-tick decode blocks), with per-request TTFT / inter-token latency
  and dispatch accounting; ``--trace-shape`` (poisson, bursty, heavy-tail
  arrivals), ``--max-queue`` / ``--shed-policy`` (overload control),
  ``--audit`` (the invariant auditor after every decode block),
  ``--trace-out`` (a Chrome/Perfetto trace of the run's telemetry) and
  ``--events-out`` (the raw events as JSONL, for
  ``tools/torch_trace_viewer.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --decode-impl kernel --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --reduced --device cpu --continuous --requests 4 --n-slots 2 \
        --max-len 64 --chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-1.8b+ring --decode-impl kernel --continuous \
        --n-slots 4 --max-len 6144 --chunk 128 --prompt-len 5120 --gen 96
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b+w4a8 \
        --reduced --device cpu --continuous --requests 4 --n-slots 2 \
        --max-len 64 --chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --reduced --device cpu --continuous --requests 8 --n-slots 2 \
        --max-len 64 --chunk 8 --trace-shape bursty --max-queue 2 \
        --shed-policy shed-oldest --audit --trace-out run.trace.json \
        --events-out run.events.jsonl

Cross-attention configs (``llama-3.2-vision-90b``, ``whisper-small``) serve
with random sources, as the reference does: lock-step, one source of
``cfg.source_len`` frames per row; ``--continuous``, sources of S/4..S
rows attached to the trace, each shared by two consecutive requests (the
source-KV pool's dedup):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --reduced --device cpu --continuous --requests 4 --n-slots 2 \
        --max-len 64 --chunk 8

``+ring`` sliding-window configs (``h2o-danube-1.8b+ring``,
``hymba-1.5b+ring``, and their ``+ring+w4a8``) serve from a ring KV cache of
``round128(window + chunk)`` slots per row (``round128(window + 1)`` in
lock-step), whatever ``--max-len``. ``rwkv6-3b`` (RWKV6, no KV cache) and
``hymba-1.5b`` (attention and Mamba side by side) carry recurrent state per
row.

Weights are random, drawn from ``--seed``. Runs on the GPU unless
``--device cpu`` is given; with no GPU and no ``--device`` it fails.

The run goes under a device mesh, as the reference's runs go under ``with
mesh:``: ``--production-mesh`` builds the 16 x 16 production mesh over a
``torchrun`` world of 256 ranks (without one it fails and says so),
otherwise the host mesh over the world ``torchrun`` gives, or, run as a
plain process, none. The mesh is torch's current ``DeviceMesh`` for the
run (``with mesh:``), and, as in the reference, no distribution context
is installed: the MoE keeps its single-process dispatch and ``--decode-impl
sp`` reads blockwise.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models.api import build_model, needs_source
from repro_torch.serving import (ContinuousBatchingEngine, EngineAuditor,
                                 OverloadConfig, ServingEngine, Telemetry,
                                 load_trace, poisson_trace)
from repro_torch.serving.scheduler import SHED_POLICIES
from repro_torch.serving.workload import TRACE_SHAPES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=0, help="default: pow2 fit")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-impl", default=None,
                    choices=["blockwise", "tokenwise", "kernel", "naive", "sp"],
                    help="sp: sequence-parallel decode under a distribution "
                         "context; the launcher sets none (as the reference's "
                         "does not), so sp reads blockwise here")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh over a torchrun world of 256 ranks")
    ap.add_argument("--device", default=None,
                    help="default: cuda (fails without a GPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out")
    # --- continuous batching ---
    ap.add_argument("--continuous", action="store_true",
                    help="ragged continuous batching over a request trace")
    ap.add_argument("--n-slots", type=int, default=0,
                    help="KV slot pool size (default: --batch)")
    ap.add_argument("--requests", type=int, default=16,
                    help="continuous: trace length")
    ap.add_argument("--chunk", type=int, default=16,
                    help="continuous: prefill chunk size")
    ap.add_argument("--decode-ticks", type=int, default=1,
                    help="continuous: decode ticks per block (K); the host "
                         "syncs once per block")
    ap.add_argument("--rate", type=float, default=None,
                    help="continuous: mean arrival rate req/s "
                         "(default: backlogged)")
    ap.add_argument("--trace", default=None,
                    help="continuous: JSON trace file instead of generated "
                         "arrivals")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--trace-shape", default="poisson", choices=list(TRACE_SHAPES),
                    help="continuous: interarrival shape: poisson, bursty "
                         "(near-simultaneous clumps) or heavy-tail (Lomax gaps)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="continuous: bound the admission queue (overload "
                         "control; default unbounded)")
    ap.add_argument("--shed-policy", default="reject", choices=list(SHED_POLICIES),
                    help="continuous: what a full queue does: reject the "
                         "incoming request, shed the oldest queued one, or "
                         "degrade the queued decode budgets")
    ap.add_argument("--audit", action="store_true",
                    help="continuous: run the engine invariant auditor after "
                         "every decode block")
    ap.add_argument("--trace-out", default=None,
                    help="continuous: write the run's telemetry as a "
                         "Chrome/Perfetto trace (one lane per slot)")
    ap.add_argument("--events-out", default=None,
                    help="continuous: stream the raw telemetry events as JSONL "
                         "(convert with tools/torch_trace_viewer.py)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.decode_impl:
        cfg = cfg.replace(decode_impl=args.decode_impl)
    device = resolve_device(args.device)
    mesh = launcher_mesh(args.production_mesh, device.type)    # the world before the model
    model = build_model(cfg, device=device)
    dtype = getattr(torch, cfg.compute_dtype)
    params = model.init_params(args.seed, dtype=dtype)
    with mesh if mesh is not None else contextlib.nullcontext():
        if args.continuous:
            return _run_continuous(args, cfg, model, params)
        return _run_lockstep(args, cfg, model, params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_lockstep(args, cfg, model, params):
    need = args.prompt_len + args.gen
    max_len = args.max_len or (1 << (need - 1).bit_length())
    src = None
    if needs_source(cfg):
        # random frontend features, one full-length source per row
        src_gen = torch.Generator(device=model.device).manual_seed(args.seed + 1)
        src = (torch.randn((args.batch, cfg.source_len, cfg.d_model), generator=src_gen,
                           device=model.device) * 0.02).to(getattr(torch, cfg.compute_dtype))
    eng = ServingEngine(model, params, max_len=max_len, batch=args.batch,
                        source_len=cfg.source_len if src is not None else None)
    gen = torch.Generator(device=model.device).manual_seed(args.seed + 2)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=model.device)
    # sampling keys: the reference's PRNGKey(seed) stream (--seed 0: its default)
    key = prng.prng_key(args.seed, device=model.device)
    # warmup: kernel builds, allocator, cuBLAS handles
    eng.generate(prompts, steps=2, temperature=args.temperature, rng=key, source=src)
    _sync(model.device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=args.gen, temperature=args.temperature, rng=key,
                       source=src)
    _sync(model.device)
    wall = time.perf_counter() - t0

    toks = args.batch * args.gen
    device_name = (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu")
    metrics = {"arch": args.arch, "decode_impl": cfg.decode_impl,
               "device": device_name, "batch": args.batch,
               "prompt_len": args.prompt_len, "generated": args.gen,
               "wall_s": wall, "tokens_per_s": toks / wall,
               "ms_per_token_step": 1e3 * wall / args.gen}
    print(json.dumps(metrics))
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(metrics, indent=1))
    return out, metrics


def _run_continuous(args, cfg, model, params):
    n_slots = args.n_slots or args.batch
    max_len = args.max_len or 256
    if args.trace:
        trace = load_trace(args.trace, cfg.vocab_size)
    else:
        src_kw = {}
        if needs_source(cfg):
            # heterogeneous source lengths, each source shared by a pair
            src_kw = dict(source_len=(max(1, cfg.source_len // 4), cfg.source_len),
                          source_dim=cfg.d_model, source_share=2)
        trace = poisson_trace(
            n_requests=args.requests, vocab_size=cfg.vocab_size,
            rate=args.rate, prompt_len=(min(8, args.prompt_len), args.prompt_len),
            max_new=(min(4, args.gen), args.gen), seed=args.seed,
            shape=args.trace_shape, **src_kw)
    telemetry = (Telemetry(jsonl_path=args.events_out)
                 if (args.trace_out or args.events_out) else None)
    overload = (OverloadConfig(max_queue=args.max_queue, policy=args.shed_policy)
                if args.max_queue else None)
    eng = ContinuousBatchingEngine(
        model, params, n_slots=n_slots, max_len=max_len, chunk=args.chunk,
        eos_id=args.eos_id, temperature=args.temperature, seed=args.seed,
        decode_ticks=args.decode_ticks, telemetry=telemetry, overload=overload,
        auditor=EngineAuditor() if args.audit else None)
    eng.warmup()
    # a Ctrl-C inside run() unwinds there: the report comes back with
    # interrupted: true, so the sinks below still flush
    report = eng.run(trace)
    if telemetry is not None:
        if args.trace_out:
            telemetry.write_chrome_trace(args.trace_out)
        telemetry.close()
    device_name = (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu")
    metrics = {"arch": args.arch, "mode": "continuous", "decode_impl": cfg.decode_impl,
               "device": device_name, "n_slots": n_slots, "max_len": max_len,
               "chunk": args.chunk, **report["aggregate"]}
    print(json.dumps(metrics))
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(
            {"metrics": metrics, "requests": report["requests"]}, indent=1))
    return report, metrics


if __name__ == "__main__":
    main()
