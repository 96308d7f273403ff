"""Training step: the loss and its gradient by autograd, then AdamW, with
microbatched gradient accumulation. Port of ``repro.train.step``.

The global batch splits into ``microbatches`` sequential chunks, in order;
their gradients are summed in float32 and divided at the end, and so are
their losses, as the reference's ``lax.scan`` accumulates them.

With ``param_specs`` (FSDP: the params are ``DTensor`` s placed by
``sharding.param_specs(train=True)`` under an active
``distributed.context``, as ``launch.train.shard_train_state`` makes
them), the gradients and the accumulation carry are redistributed to the
params' placements (:func:`_constrain`, the reference's
``with_sharding_constraint``), and the step runs under
``implicit_replication``: the plain tensors the forward makes (positions,
RoPE tables, masks) count as replicated, as a plain tensor does in the
distribution context.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.sharding import constrain, is_dtensor, replicated_value
from repro_torch.models.api import lm_loss
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.tree import tree_items, tree_map


def _constrain(tree: dict, spec_tree: dict | None) -> dict:
    """Pin a params-shaped tree (gradients, the accumulation carry) to the
    params' specs: every ``DTensor`` leaf redistributed to its spec's
    placements. A no-op when ``spec_tree`` is None, outside a distribution
    context and on plain leaves."""
    if spec_tree is None:
        return tree
    return tree_map(constrain, tree, spec_tree)


def _placed_as(part, whole):
    """A microbatch of ``whole`` placed as ``whole`` is: DTensor gathers a
    batch-sharded tensor to cut it into chunks, and each chunk would then
    be computed whole on every process of the batch axes."""
    return part.redistribute(whole.device_mesh, whole.placements) if is_dtensor(whole) else part


def _value_and_grad(loss_fn, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """``jax.value_and_grad(loss_fn)(params, batch)``: the loss, and the
    gradient of every leaf in the leaf's dtype (zeros for a leaf the loss
    does not use)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = [v for _, v in tree_items(leaves)]
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(v): torch.zeros_like(v) if g is None else g for v, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda v: by_leaf[id(v)], leaves)


def make_train_step(model, *, microbatches: int = 1, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, remat: bool = True,
                    param_specs=None, bf16_gather: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` is ``{tokens, labels[, source]}`` with the global
    batch leading (plain tensors, or ``DTensor`` s sharded over the batch
    axes). Like the reference's jitted step, which donates them, the step
    updates ``params`` and ``opt_state`` in place and returns them;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` ([] f32 plain
    tensors). ``train_step.loss_and_grads(params, batch)`` gives the step's
    loss and gradients alone.

    ``param_specs``: the spec tree of the params (``DTensor`` s placed by
    it): gradients and the accumulation carry take the params' placements.
    ``bf16_gather``: the float32 leaves of 2 or more dims are cast to the
    compute dtype before the loss (the gradient flows back through the
    cast), while still sharded: FSDP's gathers then move the compute
    dtype."""
    cdt = getattr(torch, model.cfg.compute_dtype)

    def loss_fn(params, batch):
        if bf16_gather:
            params = _constrain(tree_map(lambda p: p.to(cdt) if p.dtype == torch.float32
                                         and p.dim() >= 2 else p, params), param_specs)
        return lm_loss(model, params, batch["tokens"], batch["labels"], batch.get("source"),
                       remat=remat)

    def loss_and_grads(params, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
            return loss, _constrain(grads, param_specs)
        if batch["tokens"].shape[0] % microbatches:
            raise ValueError(f"train_step: global batch {batch['tokens'].shape[0]} does "
                             f"not split into {microbatches} microbatches")
        dev = batch["tokens"].device
        n = torch.tensor(float(microbatches), device=dev)   # a tensor divisor: see adamw
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = _constrain(tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                    params), param_specs)
        parts = {k: v.chunk(microbatches) for k, v in batch.items()}
        for i in range(microbatches):
            one_loss, one = _value_and_grad(loss_fn, params,
                                            {k: _placed_as(v[i], batch[k])
                                             for k, v in parts.items()})
            one = _constrain(one, param_specs)
            grads = _constrain(tree_map(lambda a, g: a + g.float(), grads, one), param_specs)
            loss = loss + one_loss
        return loss / n, tree_map(lambda g: g / n, grads)

    def sharded():
        if param_specs is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def train_step(params, opt_state, batch):
        with sharded():
            loss, grads = loss_and_grads(params, batch)
            lr = cosine_schedule(opt_state.step, base_lr=base_lr, warmup=warmup,
                                 total=total_steps)
            params, opt_state, metrics = adamw_update(params, grads, opt_state, lr=lr,
                                                      weight_decay=weight_decay)
        metrics["loss"] = replicated_value(loss)
        return params, opt_state, metrics

    def step_loss_and_grads(params, batch):
        with sharded():
            return loss_and_grads(params, batch)

    train_step.loss_and_grads = step_loss_and_grads
    return train_step
