"""Training step: the loss and its gradient by autograd, then AdamW, with
microbatched gradient accumulation. Port of ``repro.train.step``.

The global batch splits into ``microbatches`` sequential chunks, in order;
their gradients are summed in float32 and divided at the end, and so are
their losses, as the reference's ``lax.scan`` accumulates them. The FSDP
constraints of the reference (``param_specs``, ``_constrain``) wait for the
distributed slice (ROADMAP §1 item 8).
"""
from __future__ import annotations

import torch

from repro_torch.models.api import lm_loss
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.tree import tree_items, tree_map


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
    batch leading. Like the reference's jitted step, which donates them,
    the step updates ``params`` and ``opt_state`` in place and returns
    them; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` ([] f32
    tensors).

    ``bf16_gather``: the float32 leaves of 2 or more dims are cast to the
    compute dtype before the loss (the gradient flows back through the
    cast). ``param_specs`` (FSDP sharding) is not ported and raises."""
    if param_specs is not None:
        raise NotImplementedError("make_train_step: param_specs (FSDP sharding) is not "
                                  "ported yet (ROADMAP §1 item 8)")
    cdt = getattr(torch, model.cfg.compute_dtype)

    def loss_fn(params, batch):
        if bf16_gather:
            params = tree_map(lambda p: p.to(cdt) if p.dtype == torch.float32 and p.dim() >= 2
                              else p, params)
        return lm_loss(model, params, batch["tokens"], batch["labels"], batch.get("source"),
                       remat=remat)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            if batch["tokens"].shape[0] % microbatches:
                raise ValueError(f"train_step: global batch {batch['tokens'].shape[0]} does "
                                 f"not split into {microbatches} microbatches")
            dev = batch["tokens"].device
            n = torch.tensor(float(microbatches), device=dev)   # a tensor divisor: see adamw
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            parts = {k: v.chunk(microbatches) for k, v in batch.items()}
            for i in range(microbatches):
                one_loss, one = _value_and_grad(loss_fn, params,
                                                {k: v[i] for k, v in parts.items()})
                grads = tree_map(lambda a, g: a + g.float(), grads, one)
                loss = loss + one_loss
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        lr = cosine_schedule(opt_state.step, base_lr=base_lr, warmup=warmup,
                             total=total_steps)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, lr=lr,
                                                  weight_decay=weight_decay)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
