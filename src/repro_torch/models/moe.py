"""Token-choice top-k MoE with capacity-based scatter dispatch. Port of
``repro.models.moe``.

The router picks each token's top-k experts in float32 (ties to the lower
expert index, as ``lax.top_k`` breaks them). Prefill dispatch is GShard's
with capacity: a cumulative count over the flat ``[T * k]`` assignments
gives each (token, expert) pair its place in the expert's queue, pairs past
the capacity ``c`` drop, the kept ones are copied into an ``[E, c, d]``
buffer (every kept place is distinct, so a plain indexed copy, no float
atomics, gives the reference's scatter-add bit for bit), the experts run
as batched products, and the results come back weighted by the router.
Decode uses the capacity-free per-row form (:func:`moe_apply_rowwise`):
each row gathers its own k experts, so a row's output depends on that row
alone.

The expert products are plain batched matmuls, as in the reference (no
Pallas kernel there). Under an active ``distributed.context`` the capacity
dispatch is expert-parallel (:func:`_moe_apply_ep`): each process of the
model axis runs its ``E / ep`` experts on its batch rows, and one
all-reduce over the model axis sums the experts' partial outputs. On
``DTensor`` s (a sharded train step) the route takes each process's local
shards explicitly and its collectives are ``redistribute`` s, which carry
gradients, as the reference's ``shard_map`` does.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.context import COLLECTIVES, DistContext, get_context
from repro_torch.distributed.sharding import constrain, from_local, is_dtensor, to_local

from .layers import act_fn, dense_init


def moe_init(gen: torch.Generator, lead: tuple[int, ...], d_model: int,
             d_ff: int, n_experts: int, gated: bool = True, *,
             dtype: torch.dtype = torch.float32) -> dict:
    """Random experts in the reference's layout: ``router [*lead, d, E]``,
    ``up`` / ``gate [*lead, E, d, f]``, ``down [*lead, E, f, d]``."""
    p = {"router": dense_init(gen, (*lead, d_model, n_experts), dtype=dtype),
         "up": dense_init(gen, (*lead, n_experts, d_model, d_ff), dtype=dtype),
         "down": dense_init(gen, (*lead, n_experts, d_ff, d_model), dtype=dtype)}
    if gated:
        p["gate"] = dense_init(gen, (*lead, n_experts, d_model, d_ff), dtype=dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot of ``idx`` over ``n`` classes, by comparison: no
    bounds check that reads the device on the host (``F.one_hot`` on CUDA
    may), so decode stays free of host synchronization."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, equal values in
    index order (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xf: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router: top-k expert ids, their renormalized weights and the Switch
    load-balance loss, all from float32 logits. xf: [T, d]."""
    e = router.shape[-1]
    logits = xf.float() @ router.float()                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, top_k)                           # [T, k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    assign1 = _one_hot(top_e[:, 0], e).float()
    aux = e * torch.sum(assign1.mean(dim=0) * probs.mean(dim=0))
    return top_e, top_w, aux


def _queue_positions(top_e: torch.Tensor, e: int, c: int):
    """Each (token, slot) pair's place in its expert's queue, counted in
    flat ``[T * k]`` order, and whether it fits the capacity ``c``."""
    flat_e = top_e.reshape(-1)                                    # [T*k]
    pos = torch.cumsum(_one_hot(flat_e, e), dim=0) - 1            # exclusive count
    pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]
    return flat_e, pos_in_e, pos_in_e < c


def _expert_ffn(p: dict, buf: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """buf: [E, C, d] -> [E, C, d], every expert on its own queue."""
    dt = buf.dtype
    up = torch.bmm(buf, p["up"].to(dt))
    if gated:
        up = act_fn(act)(torch.bmm(buf, p["gate"].to(dt))) * up
    else:
        up = act_fn(act)(up)
    return torch.bmm(up, p["down"].to(dt))


def _dispatch_ffn_combine(p: dict, xf: torch.Tensor, top_e: torch.Tensor,
                          top_w: torch.Tensor, *, c: int, top_k: int, act: str,
                          gated: bool, e_lo: int = 0) -> torch.Tensor:
    """Copy the kept (token, expert) pairs of the experts ``p`` holds (the
    ``E_loc`` of its stacks, from ``e_lo`` on) into their queues, run them,
    gather each pair's result back to its token, weighted by the router.
    Dropped pairs and other experts' pairs land on a dump row past the
    queues and add nothing. xf: [T, d] -> [T, d]."""
    t, d = xf.shape
    e, e_loc = p["router"].shape[-1], p["up"].shape[-3]
    flat_e, pos_in_e, keep = _queue_positions(top_e, e, c)
    mine = keep & (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    slot = torch.where(mine, (flat_e - e_lo) * c + pos_in_e, e_loc * c)
    xe = xf[:, None].expand(t, top_k, d).reshape(t * top_k, d)   # each token k times
    buf = xf.new_zeros((e_loc * c + 1, d)).index_copy_(0, slot, xe)
    out = _expert_ffn(p, buf[: e_loc * c].view(e_loc, c, d), act, gated)  # [E_loc, C, d]
    gathered = torch.where(mine[:, None],
                           out.reshape(e_loc * c, d)[slot.clamp_max(e_loc * c - 1)], 0.0)
    w = top_w.reshape(-1)[:, None].to(xf.dtype)
    return (gathered * w).reshape(t, top_k, d).sum(dim=1)


def capacity_for(tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """GShard's places per expert: ``max(int(T * k / E * factor), 8)``."""
    return max(int(tokens * top_k / n_experts * capacity_factor), 8)


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int, act: str = "silu",
              gated: bool = True, capacity_factor: float = 1.25,
              capacity: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], the load-balance loss). The capacity
    is ``capacity`` or :func:`capacity_for` the ``T = B * S`` tokens.

    Under an active ``distributed.context`` with no ``capacity`` given,
    experts that split evenly over the model axis and a batch that splits
    evenly over the batch axes, this takes the expert-parallel route
    (:func:`_moe_apply_ep`), as the reference does. Otherwise, on
    ``DTensor`` s, :func:`_moe_apply_global`."""
    ctx = get_context()
    b, s, d = x.shape
    e = p["router"].shape[-1]
    if (ctx.active and capacity is None and ctx.model_axis is not None
            and e % ctx.axis_size(ctx.model_axis) == 0
            and b % ctx.axis_size(ctx.batch_axes) == 0):
        return _moe_apply_ep(p, x, top_k=top_k, act=act, gated=gated,
                             capacity_factor=capacity_factor, ctx=ctx)
    if any(is_dtensor(v) for v in (x, *p.values())):
        return _moe_apply_global(p, x, top_k=top_k, act=act, gated=gated,
                                 capacity_factor=capacity_factor, capacity=capacity)
    t = b * s
    xf = x.reshape(t, d)
    top_e, top_w, aux = _route(xf, p["router"], top_k)
    c = capacity if capacity is not None else capacity_for(
        t, top_k, p["router"].shape[-1], capacity_factor)
    y = _dispatch_ffn_combine(p, xf, top_e, top_w, c=c, top_k=top_k, act=act,
                              gated=gated)
    return y.reshape(b, s, d), aux


def _moe_apply_global(p: dict, x, **kw):
    """The capacity MoE on ``DTensor`` s off the expert-parallel route
    (experts that do not divide the model axis, a batch that does not
    divide the batch axes): what the reference's GSPMD program computes,
    one dispatch over the global token list with the capacity of the
    global ``T = B * S``. Every process gathers the tokens, the router and
    the expert stacks whole, runs :func:`moe_apply` on the plain tensors,
    and places ``y`` back as ``x`` was placed; the load-balance loss comes
    back replicated. Each process computes the same whole result, so
    every gradient is replicated and flows back through the gathers.

    The gathers cost each process the whole [T, d] token list and every
    expert stack in memory: the full-width cells never come here (their
    experts divide the model axis and their batches the batch axes), only
    reduced configs and meshes that do not divide."""
    mesh = next(v.device_mesh for v in (x, *p.values()) if is_dtensor(v))
    whole = lambda v: (v.full_tensor(grad_placements=[Replicate()] * mesh.ndim)
                       if is_dtensor(v) else v)
    y, aux = moe_apply({k: whole(v) for k, v in p.items()}, whole(x), **kw)
    replicated = lambda v: DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim,
                                              run_check=False)
    if is_dtensor(x):             # a partial sum in x comes back summed
        y = replicated(y).redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                              for pl in x.placements])
    return y, replicated(aux)


def _moe_apply_ep(p: dict, x, *, top_k: int, act: str, gated: bool,
                  capacity_factor: float, ctx: DistContext):
    """Expert-parallel MoE, differentiable. The token batch stays sharded
    over the batch axes; every process of the model axis routes all of its
    rows (the router is replicated), but dispatches to and runs only its
    ``E / ep`` experts; one all-reduce of the [T_loc, d] outputs over the
    model axis sums the experts' partial outputs, and the load-balance loss
    is averaged over the batch axes. The capacity is per (batch shard,
    expert): ``max(int(T_loc * k / E * cf), 8)``.

    On a ``DTensor`` ``x``: it is redistributed to (batch over the batch
    axes, replicated over the model axis) and this process's rows taken; a
    ``DTensor`` router is gathered whole and a ``DTensor`` expert stack to
    this process's experts (replicated over the batch axes: FSDP's
    gather), a plain one sliced. Each local tensor declares its gradient a
    partial sum over the axes it was computed on alone, so the backward
    reduces it. The experts' partial outputs all-reduce over the model
    axis (Partial to Replicate); the loss, counted once on the model axis,
    sums over every axis, then is divided by the batch shards; y and the
    loss come back as DTensors. A plain ``x`` counts as replicated (a
    serving batch): y and the loss come back whole, y gathered over the
    batch axes."""
    if not is_dtensor(x):
        y, aux = _moe_apply_ep(p, from_local(x, (None,) * x.dim(), x.shape), top_k=top_k,
                               act=act, gated=gated, capacity_factor=capacity_factor, ctx=ctx)
        return y.full_tensor(), aux.full_tensor()
    b, s, d = x.shape
    batch, model = ctx.batch_axes, ctx.model_axis
    e = p["router"].shape[-1]
    ep, dp = ctx.axis_size(model), ctx.axis_size(batch)
    e_loc, b_loc = e // ep, b // dp
    m_idx = ctx.axis_index(model)
    e_lo = m_idx * e_loc
    xl = to_local(x, (batch, None, None), partial_over=(model,))
    router = p["router"]
    if is_dtensor(router):
        router = to_local(router, (None, None), partial_over=(*batch, model))
    pl = {"router": router}
    for k in ("up", "gate", "down"):
        if k in p:
            pl[k] = (to_local(p[k], (model, None, None), partial_over=batch)
                     if is_dtensor(p[k]) else p[k][e_lo:e_lo + e_loc])
    xf = xl.reshape(b_loc * s, d)
    top_e, top_w, aux = _route(xf, router, top_k)
    y = _dispatch_ffn_combine(pl, xf, top_e, top_w, c=capacity_for(b_loc * s, top_k, e,
                                                                    capacity_factor),
                              top_k=top_k, act=act, gated=gated, e_lo=e_lo)
    COLLECTIVES["ep_all_reduce"] += 1
    COLLECTIVES["ep_all_reduce_bytes"] += y.numel() * y.element_size()
    y = constrain(from_local(y.reshape(b_loc, s, d), (batch, None, None), x.shape,
                             partial_over=(model,)), (batch, None, None))
    aux = aux if m_idx == 0 else aux * 0
    everywhere = (*batch, model)
    return y, constrain(from_local(aux, (), (), partial_over=everywhere), ()) / dp


def moe_apply_rowwise(p: dict, x: torch.Tensor, *, top_k: int, act: str = "silu",
                      gated: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-free per-row dispatch: x [T, d] -> (y [T, d], aux). Each row
    gathers its own k expert matrices and runs them as a ``[T * k]``-batched
    product, so no row can take capacity from another: a row's output
    depends on that row alone, whatever else shares the batch (decode in
    ragged continuous batching needs this). Equal to the capacity path
    whenever that path drops nothing."""
    t = x.shape[0]
    top_e, top_w, aux = _route(x, p["router"], top_k)             # [T, k]
    dt = x.dtype
    idx = top_e.reshape(-1)

    def picked(name):
        """Each row's k matrices of an expert stack, [T, k, a, b], copied
        whole by ``index_select`` (the same bits as ``w[top_e]``, whose
        gather computes an offset per element)."""
        w = p[name]
        return w.index_select(0, idx).view(t, top_k, *w.shape[1:]).to(dt)

    xr = x[:, None, None, :]                                      # [T, 1, 1, d]
    up = torch.matmul(xr, picked("up"))                           # [T, k, 1, f]
    if gated:
        up = act_fn(act)(torch.matmul(xr, picked("gate"))) * up
    else:
        up = act_fn(act)(up)
    y = torch.matmul(up, picked("down"))[:, :, 0]                 # [T, k, d]
    return (y * top_w[..., None].to(dt)).sum(dim=1), aux


def moe_apply_dense_ref(p: dict, x: torch.Tensor, *, top_k: int, act: str = "silu",
                        gated: bool = True) -> torch.Tensor:
    """Dense loop over the experts, no capacity: a test oracle."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    top_e, top_w, _ = _route(xf, p["router"], top_k)
    y = torch.zeros_like(xf)
    for ei in range(p["router"].shape[-1]):
        up = xf @ p["up"][ei]
        if gated:
            up = act_fn(act)(xf @ p["gate"][ei]) * up
        else:
            up = act_fn(act)(up)
        wi = torch.where(top_e == ei, top_w, 0.0).sum(dim=-1)[:, None]
        y = y + (up @ p["down"][ei]) * wi.to(x.dtype)
    return y.reshape(b, s, d)
