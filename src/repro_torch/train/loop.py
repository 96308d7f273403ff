"""Training loop with fault tolerance: periodic atomic checkpoints, resume
from the latest valid one on (re)start, bounded step retries after a
failure. Port of ``repro.train.loop``.

A restarted job finds the last valid snapshot through
``CheckpointManager.latest_step()``, and the counted data pipeline
regenerates the exact step stream, so a resumed run takes the steps an
uninterrupted one would. ``failure_injector`` lets tests drive the
recovery path deterministically.
"""
from __future__ import annotations

import logging
import time
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import batch_for_step, source_for_step
from repro_torch.models.api import needs_source
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_map

log = logging.getLogger("repro_torch.train")


class TrainLoop:
    """``train_step`` (from ``make_train_step``) over the counted batches
    of ``seed`` on the model's device.

    ``params``: the initial parameters (for example the reference's,
    through ``convert.from_jax``), copied at each start; by default the
    model's own seeded ``init_params(seed)``. ``ckpt_dir=None`` keeps no
    checkpoint (a full-size model's is tens of GB): a retry then restarts
    from the initial parameters."""

    def __init__(self, model, cfg, train_step: Callable, *, seq_len: int,
                 global_batch: int, ckpt_dir: str | None, ckpt_every: int = 50,
                 seed: int = 0, max_retries: int = 3,
                 failure_injector: Callable[[int], None] | None = None,
                 params: dict | None = None):
        self.model, self.cfg = model, cfg
        self.train_step = train_step
        self.seq_len, self.global_batch = seq_len, global_batch
        self.seed = seed
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir is not None else None
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.failure_injector = failure_injector
        self.params = params

    def _batch(self, step: int) -> dict:
        dev = self.model.device
        b = batch_for_step(self.cfg.vocab_size, self.seq_len, self.global_batch, self.seed,
                           step, device=dev)
        if needs_source(self.cfg):
            b["source"] = source_for_step(self.cfg, self.global_batch, self.seed, step,
                                          device=dev)
        return b

    def _latest(self) -> int | None:
        return None if self.ckpt is None else self.ckpt.latest_step()

    def init_or_resume(self, seed: int):
        params = (self.model.init_params(seed) if self.params is None
                  else tree_map(torch.clone, self.params))
        opt_state = adamw_init(params)
        start = 0
        latest = self._latest()
        if latest is not None:
            (params, opt_state), start, _ = self.ckpt.restore((params, opt_state), latest)
            log.info("resumed from checkpoint step %d", start)
        return params, opt_state, start

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def run(self, steps: int, seed: int | None = None) -> list[dict]:
        """Train up to step ``steps`` (from step 0, or from the latest
        checkpoint); returns each step's metrics: ``loss``, ``grad_norm``,
        ``lr``, ``step_time_s`` (host clock, after a device synchronize)
        and ``step``. A step retried after a restore appears again."""
        seed = self.seed if seed is None else seed
        params, opt_state, start = self.init_or_resume(seed)
        history = []
        step = start
        while step < steps:
            retries = 0
            while True:
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(step)
                    self._sync()
                    t0 = time.perf_counter()
                    params, opt_state, metrics = self.train_step(params, opt_state,
                                                                 self._batch(step))
                    self._sync()
                    elapsed = time.perf_counter() - t0
                    metrics = {k: float(v) for k, v in metrics.items()}
                    metrics["step_time_s"] = elapsed
                    break
                except Exception as e:  # a transient failure: restore and retry
                    retries += 1
                    log.warning("step %d failed (%s); retry %d/%d", step, e, retries,
                                self.max_retries)
                    if retries > self.max_retries:
                        raise
                    latest = self._latest()
                    if latest is not None:
                        (params, opt_state), step, _ = self.ckpt.restore((params, opt_state),
                                                                         latest)
                    else:  # restart from scratch, deterministically
                        params, opt_state, step = (*self.init_or_resume(seed)[:2], 0)
            metrics["step"] = step
            history.append(metrics)
            step += 1
            if self.ckpt is not None and (step % self.ckpt_every == 0 or step == steps):
                self.ckpt.save(step, (params, opt_state), extra={"seq_len": self.seq_len})
        self._final = (params, opt_state)
        return history
