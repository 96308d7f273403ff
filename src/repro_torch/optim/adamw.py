"""AdamW with float32 moments and master updates, global-norm clipping and
a cosine schedule with warmup. Port of ``repro.optim.adamw``.

The arithmetic is the reference's, op for op in float32: the moments and
the update are float32 and cast back to each parameter's dtype, ``b1 **
step`` is a float32 power, the clip scale is ``min(1, clip_norm / (gnorm +
1e-9))``, and weight decay applies to every leaf. No ``torch.optim``
class: the update order and the leaves decayed must be the reference's.

Like the reference's jitted step, which donates its parameter and state
buffers, :func:`adamw_update` writes the new values into the tensors of
``params`` and ``state`` (under ``torch.no_grad()``) and returns them.
Divisions take tensor operands: CUDA divides by a Python scalar as a
multiply by its reciprocal, a different rounding.

Leaves may be ``DTensor`` s (a sharded train step): the global norm is the
full gradient's, summed across the shards, the clip scale a replicated
scalar, and each leaf's update runs on its local shard, in place, the same
elementwise ops as on a plain leaf. A leaf's moments carry its placements
(:func:`adamw_init`); its gradient is redistributed to them first.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import is_dtensor, replicated_value
from repro_torch.tree import tree_items, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # [] int32
    mu: dict            # first moment, float32, params-shaped
    nu: dict            # second moment, float32, params-shaped


def adamw_init(params: dict) -> AdamWState:
    """Zero moments in float32, each with its leaf's placements when the
    leaf is a ``DTensor``."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    some = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=some.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``: [] float32."""
    sf = step.float()
    warm = base_lr * (sf + 1) / _f32(max(warmup, 1), sf)
    t = torch.clamp((step - warmup).float() / _f32(max(total - warmup, 1), sf), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos).float()


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves (in the reference's order) of each
    leaf's float32 sum of squares."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, *, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0
                 ) -> tuple[dict, AdamWState, dict]:
    """Returns (params, state, metrics): the tensors of ``params`` and
    ``state`` updated in place, and ``{"grad_norm", "lr"}``."""
    gnorm = replicated_value(global_norm(grads))
    scale = torch.minimum(_f32(1.0, gnorm), torch.div(_f32(clip_norm, gnorm), gnorm + 1e-9))
    step = state.step + 1
    sf = step.float()
    b1c = 1 - torch.pow(_f32(b1, sf), sf)
    b2c = 1 - torch.pow(_f32(b2, sf), sf)
    mus, nus = dict(tree_items(state.mu)), dict(tree_items(state.nu))
    gs = dict(tree_items(grads))
    for path, p in tree_items(params):
        g, m, n = gs[path], mus[path], nus[path]
        if is_dtensor(p):
            if g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)
            if not m.placements == n.placements == p.placements:
                raise ValueError(f"adamw_update: {path}'s moments are placed as "
                                 f"{m.placements}, the leaf as {p.placements}")
            p, g, m, n = (t.to_local() for t in (p, g, m, n))
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        n.copy_(b2 * n + (1 - b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(n / b2c) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
