#!/usr/bin/env python3
"""Where a training step's time goes on the GPU: h2o-danube-1.8b at full
size (leg TR1's setup: float32 masters, bf16 compute, remat "full", batch
8 x 1024 of the counted pipeline), one step split into its phases with a
device synchronize between them (the batch, the loss and its gradient,
the AdamW update), then the same step under ``torch.profiler``: device
time by kernel (the top ``--top``) and by kind (cuBLAS products, the rest),
and the device's idle share of the step. ``--sweep LR ...`` then runs
leg TR1 (6 steps through ``TrainLoop`` from the seeded init, warmup 2) at
each base learning rate and prints its losses and gradient norms (at 0
the parameters stay the init's, so each step's gradient norm is the
init's on that step's batch).

    python3 tools/train_breakdown.py [--layers 24] [--top 15] [--sweep 0 5e-5 1e-3]

Needs one GPU; imports the port only.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--sweep", type=float, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.device import resolve_device
    from repro_torch.models.api import build_model, lm_loss
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
    from repro_torch.train import TrainLoop, make_train_step
    from repro_torch.train.step import _value_and_grad

    resolve_device()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=args.layers)
    model = build_model(cfg)
    params = model.init_params(0)
    opt = adamw_init(params)
    step_fn = make_train_step(model, base_lr=args.lr, warmup=2, total_steps=6)
    sync = torch.cuda.synchronize

    def batch(step):
        return batch_for_step(cfg.vocab_size, 1024, 8, 0, step, device="cuda")

    for step in range(2):                                  # warm-up
        params, opt, _ = step_fn(params, opt, batch(step))
    sync()
    times = defaultdict(list)
    for step in range(2, 5):
        t0 = time.perf_counter()
        b = batch(step)
        sync()
        t1 = time.perf_counter()
        loss, grads = _value_and_grad(
            lambda p, bb: lm_loss(model, p, bb["tokens"], bb["labels"]), params, b)
        sync()
        t2 = time.perf_counter()
        lr = cosine_schedule(opt.step, base_lr=args.lr, warmup=2, total=6)
        params, opt, _ = adamw_update(params, grads, opt, lr=lr)
        del grads
        sync()
        t3 = time.perf_counter()
        for name, dt in (("batch", t1 - t0), ("loss and gradient", t2 - t1),
                         ("AdamW update", t3 - t2), ("step", t3 - t0)):
            times[name].append(dt * 1e3)
    for name, ms in times.items():
        print(f"{name:18s} " + " ".join(f"{x:8.1f}" for x in ms) + " ms")

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch(5))
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in events) / 1e3
    print(f"profiled step: wall {wall:.1f} ms, device kernel time {total:.1f} ms, "
          f"idle share {1 - total / wall:.3f}, {sum(e.count for e in events)} kernels")
    kinds = defaultdict(float)
    for e in events:
        name = e.key.lower()
        kind = ("cuBLAS product" if any(k in name for k in ("gemm", "sm90", "cutlass", "cublas"))
                else "reduction" if any(k in name for k in ("reduce", "norm", "softmax", "sum"))
                else "elementwise and copies")
        kinds[kind] += e.device_time_total / 1e3
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:24s} {ms:9.1f} ms ({ms / total:.3f})")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:args.top]:
        print(f"  {e.device_time_total / 1e3:9.1f} ms {e.count:6d}x  {e.key[:100]}")
    del params, opt, prof
    torch.cuda.empty_cache()
    for lr in args.sweep:
        loop = TrainLoop(model, cfg, make_train_step(model, base_lr=lr, warmup=2, total_steps=6),
                         seq_len=1024, global_batch=8, ckpt_dir=None)
        hist = loop.run(6)
        del loop
        torch.cuda.empty_cache()
        print(f"base lr {lr:g}: loss {[round(h['loss'], 4) for h in hist]} "
              f"grad_norm {[round(h['grad_norm'], 2) for h in hist]}")


if __name__ == "__main__":
    main()
