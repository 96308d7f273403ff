"""Distributed training entry point. Port of ``repro.launch.train``.

Runs the fault-tolerant ``TrainLoop`` over the counted synthetic batches
under a device mesh, torch's current ``DeviceMesh`` for the run, as the
reference runs it under ``with mesh:`` (neither installs a distribution
context). ``--production-mesh`` builds the 16 x 16 production mesh over a
``torch.distributed`` world of 256 ranks, which ``torchrun`` describes in
the environment (``launch.mesh.init_world``; without one it fails and says
so); otherwise the host mesh over the world ``torchrun`` gives, or, run as
a plain process, none. As in the reference, ``main`` does not pass
``param_specs`` to the step: the loop's params are plain tensors, which
count as replicated, and in a world of several ranks rank 0 alone writes
the checkpoints (``CheckpointManager``). :func:`shard_train_state` places
params and AdamW state on a mesh with the production specs, for a step
made with ``make_train_step(param_specs=)``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --device cpu --steps 3 --seq-len 16 --global-batch 2 \
        --ckpt-dir build/ckpt --metrics-out history.json
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 6 --seq-len 1024 --global-batch 8 --lr 5e-5 --ckpt-every 100
    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch qwen3-8b --production-mesh

It runs on the GPU unless ``--device cpu`` is given; with no GPU and no
``--device`` it fails. It logs the run's tokens/s and final loss, and
``--metrics-out`` writes each step's metrics as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshRules, device_put, fixup_tree, param_specs
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init
from repro_torch.train import TrainLoop, make_train_step

log = logging.getLogger("repro_torch.launch.train")


def shard_train_state(model, mesh, seed: int = 0):
    """The seeded params and their AdamW state on ``mesh`` with the
    production specs: ``(params, opt_state, specs)``, every leaf a
    ``DTensor`` placed by ``fixup_tree(param_specs(train=True))`` (FSDP
    over data, TP over model), the moments with their leaf's placements,
    the step replicated. Each rank draws the full params from the seed and
    keeps its slice (no collective)."""
    params = model.init_params(seed)
    specs = fixup_tree(param_specs(params, MeshRules(mesh), train=True), params, mesh)
    params = device_put(params, specs, mesh)
    return params, adamw_init(params), specs


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
                    help="the 16x16 mesh over a torchrun world of 256 ranks")
    ap.add_argument("--metrics-out")
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    mesh = launcher_mesh(args.production_mesh, device.type)    # the world before the model
    model = build_model(cfg, device=device)
    log.info("device: %s; mesh: %s", model.device, mesh)
    step_fn = make_train_step(model, microbatches=args.microbatches, base_lr=args.lr,
                              total_steps=args.steps)
    with mesh if mesh is not None else contextlib.nullcontext():
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
