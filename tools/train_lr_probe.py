#!/usr/bin/env python3
"""Training losses of the reference and the port side by side, on the CPU:
h2o-danube-1.8b at every published width but cut to a few layers, bf16
compute on float32 masters, ``TrainLoop`` over the counted batches (seed 0)
with ``make_train_step(base_lr=LR, warmup=2, total_steps=6)``, for each LR.
Each package inits its own weights from seed 0 (other draws, so the two
trajectories differ step by step); the question is whether a learning
rate makes both climb or both fall.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/train_lr_probe.py \
        --layers 2 --lr 1e-3 1e-4

Imports both packages (a comparison, as the tests are); the port itself
imports no JAX. ~4 GB of memory per package at 2 layers.
"""
from __future__ import annotations

import argparse
import tempfile


def _reference(lr: float, layers: int, seq: int, batch: int, ckpt: str) -> list[dict]:
    from repro.configs import get_config
    from repro.models.api import build_model
    from repro.train import TrainLoop, make_train_step
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=layers)
    model = build_model(cfg)
    step = make_train_step(model, base_lr=lr, warmup=2, total_steps=6)
    return TrainLoop(model, cfg, step, seq_len=seq, global_batch=batch, ckpt_dir=ckpt,
                     ckpt_every=100).run(6)


def _port(lr: float, layers: int, seq: int, batch: int) -> list[dict]:
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainLoop, make_train_step
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=layers)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, base_lr=lr, warmup=2, total_steps=6)
    return TrainLoop(model, cfg, step, seq_len=seq, global_batch=batch, ckpt_dir=None).run(6)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-3, 1e-4])
    args = ap.parse_args(argv)
    for lr in args.lr:
        with tempfile.TemporaryDirectory() as ckpt:
            runs = {"reference": _reference(lr, args.layers, args.seq_len, args.global_batch,
                                            ckpt),
                    "port": _port(lr, args.layers, args.seq_len, args.global_batch)}
        for name, hist in runs.items():
            print(f"lr {lr:g} {name:9s} loss {[round(h['loss'], 3) for h in hist]} "
                  f"grad_norm {[round(h['grad_norm'], 1) for h in hist]}")


if __name__ == "__main__":
    main()
