"""Serving entry point: prefill + per-token decode (the paper's workload) in
lock-step. Port of ``repro.launch.serve`` (the lock-step mode; the
continuous mode waits for ROADMAP §1 item 5).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --decode-impl kernel --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --device cpu

Weights are random, drawn from ``--seed``. Runs on the GPU unless
``--device cpu`` is given; with no GPU and no ``--device`` it fails.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine


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
                    choices=["blockwise", "kernel", "naive"])
    ap.add_argument("--device", default=None,
                    help="default: cuda (fails without a GPU)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out")
    args = ap.parse_args(argv)
    if args.continuous:
        raise SystemExit("--continuous: the continuous-batching engine is not "
                         "ported yet (ROADMAP §1 item 5); use repro.launch.serve")

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.decode_impl:
        cfg = cfg.replace(decode_impl=args.decode_impl)
    model = build_model(cfg, device=args.device)
    dtype = getattr(torch, cfg.compute_dtype)
    params = model.init_params(args.seed, dtype=dtype)
    return _run_lockstep(args, cfg, model, params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_lockstep(args, cfg, model, params):
    need = args.prompt_len + args.gen
    max_len = args.max_len or (1 << (need - 1).bit_length())
    eng = ServingEngine(model, params, max_len=max_len, batch=args.batch)
    gen = torch.Generator(device=model.device).manual_seed(args.seed + 2)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=model.device)
    sample_gen = torch.Generator(device=model.device)
    # warmup: kernel builds, allocator, cuBLAS handles
    eng.generate(prompts, steps=2, temperature=args.temperature,
                 generator=sample_gen.manual_seed(args.seed))
    _sync(model.device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps=args.gen, temperature=args.temperature,
                       generator=sample_gen.manual_seed(args.seed))
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


if __name__ == "__main__":
    main()
