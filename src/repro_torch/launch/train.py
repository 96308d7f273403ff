"""Training entry point: the fault-tolerant ``TrainLoop`` over the counted
synthetic batches, on one device. Port of ``repro.launch.train`` without
the mesh: ``--production-mesh`` (FSDP and tensor parallelism over a device
mesh) waits for ROADMAP §1 item 8.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --device cpu --steps 3 --seq-len 16 --global-batch 2 \
        --ckpt-dir build/ckpt --metrics-out history.json
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 6 --seq-len 1024 --global-batch 8 --lr 5e-5 --ckpt-every 100

It runs on the GPU unless ``--device cpu`` is given; with no GPU and no
``--device`` it fails. It logs the run's tokens/s and final loss, and
``--metrics-out`` writes each step's metrics as JSON.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.train import TrainLoop, make_train_step

log = logging.getLogger("repro_torch.launch.train")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16x16 mesh: not ported (ROADMAP §1 item 8)")
    ap.add_argument("--metrics-out")
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError("--production-mesh: the device mesh is not ported yet "
                                  "(ROADMAP §1 item 8)")

    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device)
    log.info("device: %s", model.device)
    step_fn = make_train_step(model, microbatches=args.microbatches, base_lr=args.lr,
                              total_steps=args.steps)
    loop = TrainLoop(model, cfg, step_fn, seq_len=args.seq_len,
                     global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every)
    t0 = time.perf_counter()
    history = loop.run(args.steps)
    wall = time.perf_counter() - t0

    tok_s = args.steps * args.seq_len * args.global_batch / wall
    log.info("done: %d steps in %.1fs (%.0f tok/s); final loss %.4f",
             args.steps, wall, tok_s, history[-1]["loss"])
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(history, indent=1))
    return history


if __name__ == "__main__":
    main()
