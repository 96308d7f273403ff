"""Sharding rules: parameter, batch and cache specs per (arch, shape). Port
of ``repro.distributed.sharding``.

Scheme:
  * ``pod``   — pure DP across pods (gradient all-reduce).
  * ``data``  — batch DP + FSDP for training (params and optimizer sharded,
                gathered at use); TP-only (no FSDP) for serving.
  * ``model`` — TP: d_ff and the attention projections' output dims,
                vocab, MoE experts (EP). Decode KV caches shard their
                *sequence* over ``model`` and their batch over (pod, data);
                the SwiftKV monoid merge makes the sequence split exact
                (``sp_attention.py``).

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names, or None (replicated), the entries of the reference's
``PartitionSpec``. :func:`placements` turns one into the ``DTensor``
placements of a mesh, :func:`named` a tree of them (the reference's
``named``), :func:`device_put` places a tree's leaves as ``DTensor`` s, and
:func:`constrain` is ``with_sharding_constraint``: a ``redistribute``.
Non-divisible dims fall back to replicated (:func:`fixup_divisibility`).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.tree import tree_items

from .context import get_context, mesh_shape

Spec = tuple


@dataclass(frozen=True)
class MeshRules:
    mesh: object

    @property
    def has_pod(self) -> bool:
        return "pod" in mesh_shape(self.mesh)

    @property
    def batch_axes(self):
        return ("pod", "data") if self.has_pod else ("data",)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= mesh_shape(self.mesh)[a]
        return n

    @property
    def tp_size(self) -> int:
        return mesh_shape(self.mesh)["model"]


def mesh_axis_names(multi_pod: bool):
    return ("pod", "data", "model") if multi_pod else ("data", "model")


# (path regex, spec for trailing dims): first match wins. ``F`` marks the
# FSDP axis (data for train, None for serve); leading [L]/[G] stack axes
# get None.
_RULES: list[tuple[str, tuple]] = [
    (r"embed$",                    ("model", None)),
    # unembed: model-parallel over vocab only (sharding its d dim would make
    # the logits' contraction partial over data)
    (r"unembed$",                  (None, "model")),
    (r"router$",                   ("F", None)),
    # column-parallel (output dim sharded); __qp/__qs are the W4A8 packed
    # weight and group scales (same layout, N sharded)
    (r"(wq|wk|wv|up|gate)(__q[ps])?$", ("F", "model")),
    (r"(in_proj|x_proj)$",         ("F", "model")),
    (r"(wr|wg|fk|fr|w_a)$",        ("F", "model")),
    # row-parallel (input dim sharded); the W4A8 twins keep K on model
    (r"(wo|down)__q[ps]$",         ("model", None)),
    (r"(wo|down|out_proj|fv|w_b)$", ("model", "F")),
    (r"conv_w$",                   (None, "model")),
    (r"a_log$",                    ("model", None)),
]


def _spec_for(path: str, ndim: int, fsdp) -> Spec:
    if ndim <= 1:
        return ()  # scalars, per-layer scalars and vectors: replicated
    # MoE expert stacks [L, E, din, dout]: experts over model (EP), FSDP on din
    if re.search(r"ffn/(up|gate|down)$", path) and ndim == 4:
        return (None, "model", fsdp, None)
    for pat, trailing in _RULES:
        if re.search(pat, path):
            tr = tuple(fsdp if a == "F" else a for a in trailing)
            if len(tr) > ndim:
                tr = tr[-ndim:]
            return (None,) * (ndim - len(tr)) + tr
    return ()  # norms, scalars, small vectors: replicated


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(name, (tuple, list)):
        n = 1
        for a in name:
            n *= shape[a]
        return n
    return shape[name]


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, or the leaf itself when it is one (the
    ``(shape, dtype)`` pairs of ``input_specs`` give their first item)."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if len(leaf) == 2 and isinstance(leaf[0], tuple):
        return leaf[0]
    return tuple(leaf)


def fixup_divisibility(spec: Spec, shape, mesh) -> Spec:
    """Drop sharding on dims the mesh axes do not divide evenly (a 503-token
    vocab, hymba's 25 heads, whisper's 51865 vocab, batch 1 decode); the
    spec comes back with one entry per dim."""
    dims = tuple(shape)
    out = []
    for i, name in enumerate(tuple(spec) + (None,) * (len(dims) - len(spec))):
        if name is not None and dims[i] % _axis_size(mesh, name) != 0:
            name = None
        out.append(name)
    return tuple(out)


def fixup_tree(specs_tree: dict, shapes_tree: dict, mesh) -> dict:
    """:func:`fixup_divisibility` leaf by leaf over matching trees."""
    return {k: fixup_tree(v, shapes_tree[k], mesh) if isinstance(v, dict)
            else fixup_divisibility(v, _shape(shapes_tree[k]), mesh)
            for k, v in specs_tree.items()}


def _unflatten(items: dict) -> dict:
    out: dict = {}
    for path, v in items.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def param_specs(params_shapes: dict, rules: MeshRules, *, train: bool) -> dict:
    """The spec of every leaf of a params tree (tensors or shapes).
    ``train``: FSDP over data; serve: TP only. Non-divisible dims fall back
    to replicated."""
    fsdp = "data" if train else None
    return _unflatten({path: fixup_divisibility(_spec_for(path, len(_shape(leaf)), fsdp),
                                                _shape(leaf), rules.mesh)
                       for path, leaf in tree_items(params_shapes)})


def _batch_entry(shape: ShapeSpec, rules: MeshRules):
    """The batch dim's entry: the batch axes when they divide the global
    batch (one axis by its name, as ``PartitionSpec`` writes a 1-tuple),
    else None."""
    if shape.global_batch % rules.dp_size:
        return None
    axes = rules.batch_axes
    return axes[0] if len(axes) == 1 else axes


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, rules: MeshRules) -> dict:
    """Specs of the input batch of one cell."""
    bd = _batch_entry(shape, rules)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": (bd, None)}
        if shape.kind == "train":
            specs["labels"] = (bd, None)
        if cfg.family in ("vlm", "audio"):
            specs["source"] = (bd, None, None)
        return specs
    # decode: tokens [B] + the cache
    return {"tokens": (bd,), "cache": cache_specs(cfg, shape, rules)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, rules: MeshRules) -> dict:
    """KV caches: batch over (pod, data) when divisible, *sequence* over the
    model axis (sequence-parallel decode). Recurrent states: batch over the
    data axes, channels over model."""
    bd = _batch_entry(shape, rules)
    # ring KV caches are ~window-sized: their sequence dim stays replicated
    seq_ax = None if cfg.kv_ring else "model"
    specs: dict = {"len": (bd,)}
    if cfg.family == "ssm":
        specs.update(rwkv_att=(None, bd, "model"), rwkv_ffn=(None, bd, "model"),
                     rwkv_wkv=(None, bd, "model", None, None))
        return specs
    specs["k"] = (None, bd, seq_ax, None, None)
    specs["v"] = specs["k"]
    if cfg.rotary_dim:
        specs["rope_cos"] = (bd, None)
        specs["rope_sin"] = (bd, None)
    if cfg.family == "hybrid":
        specs["mamba_conv"] = (None, bd, None, "model")
        specs["mamba_ssm"] = (None, bd, "model", None)
    if cfg.cross_attn_every:
        specs["cross_k"] = (None, bd, None, None, None)
        specs["cross_v"] = specs["cross_k"]
        specs["source_len"] = (bd,)
    return specs


def placements(spec: Spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``: for each
    mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose entry names it
    (alone or in a tuple), else ``Replicate()``."""
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, name in enumerate(spec)
                    if name == axis or (isinstance(name, tuple) and axis in name)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def named(spec_tree: dict, mesh) -> dict:
    """The placements of every spec of a tree (the reference's ``named``:
    a ``NamedSharding`` per leaf)."""
    return {k: named(v, mesh) if isinstance(v, dict) else placements(v, mesh)
            for k, v in spec_tree.items()}


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    return isinstance(x, DTensor)


def _place(x, spec: Spec, mesh):
    """``x`` as the DTensor of ``spec`` on ``mesh``: a DTensor is
    redistributed; a full tensor (the same on every rank, as a seeded init
    makes it) is cut to this rank's slice, mesh dim by mesh dim as
    ``Shard`` cuts it, with no collective."""
    want = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x if list(x.placements) == want else x.redistribute(mesh, want)
    return DTensor.from_local(local_chunk(x, want, mesh).contiguous(), mesh, want,
                              run_check=False, shape=x.shape, stride=x.stride())


def local_chunk(x: torch.Tensor, placements_: list, mesh):
    """This process's slice of the full tensor ``x`` under ``placements_``
    (each ``Shard`` cut as ``torch.chunk`` cuts it, mesh dim by mesh dim),
    with no collective."""
    for i, pl in enumerate(placements_):
        if pl.is_shard():
            x = x.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return x


def shard_range(n: int, placements_: list, mesh, dim: int) -> tuple[int, int]:
    """(first index, length) of this process's slice of a tensor dim ``dim``
    of size ``n`` under ``placements_``: :func:`local_chunk`'s cut, as
    numbers."""
    lo = 0
    for i, pl in enumerate(placements_):
        if pl.is_shard(dim):
            step = -(-n // mesh.size(i))
            start = min(mesh.get_local_rank(i) * step, n)
            lo, n = lo + start, min(step, n - start)
    return lo, n


def device_put(tree: dict, spec_tree: dict, mesh) -> dict:
    """``jax.device_put(tree, named(spec_tree, mesh))``: every leaf placed as
    a ``DTensor`` by its spec (a DTensor leaf redistributed, a full tensor
    cut to this rank's slice)."""
    return {k: device_put(v, spec_tree[k], mesh) if isinstance(v, dict)
            else _place(v, spec_tree[k], mesh) for k, v in tree.items()}


def constrain(x, spec: Spec):
    """``jax.lax.with_sharding_constraint(x, P(*spec))``: a ``DTensor``
    under an active distribution context is redistributed to ``spec``'s
    placements on the context's mesh (autograd carries the gradient back to
    its own placements); anything else comes back as it is: a plain tensor
    counts as replicated, and off a mesh the reference's constraint is a
    no-op."""
    ctx = get_context()
    if not ctx.active or not is_dtensor(x):
        return x
    return _place(x, spec, ctx.mesh)


def batch_model_spec(x, model_dim: int | None) -> Spec:
    """The spec of (batch over the context's batch axes on dim 0, its model
    axis on ``model_dim``), each only where it divides the dim, as the
    reference's ``batch_vocab_constrain``, ``_heads_constrain`` and
    ``_seq_shard`` guard theirs; every other dim (all of them but the batch
    with ``model_dim`` None) replicated. Needs an active context."""
    ctx = get_context()
    spec = [None] * x.dim()
    if x.shape[0] % ctx.axis_size(ctx.batch_axes) == 0:
        spec[0] = ctx.batch_axes
    if model_dim is not None and x.shape[model_dim] % ctx.axis_size(ctx.model_axis) == 0:
        spec[model_dim] = ctx.model_axis
    return tuple(spec)


def constrain_batch_model(x, model_dim: int | None):
    """``x`` pinned to :func:`batch_model_spec`; as it is outside a context
    and when it is a plain tensor."""
    if not get_context().active or not is_dtensor(x):
        return x
    return constrain(x, batch_model_spec(x, model_dim))


def replicate_where(x, pred):
    """A ``DTensor`` made replicated over every mesh dim ``i`` whose
    placement ``pl`` has ``pred(i, pl)``; as it is when none has, and when
    it is a plain tensor."""
    if not is_dtensor(x):
        return x
    want = [Replicate() if pred(i, pl) else pl for i, pl in enumerate(x.placements)]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


def _unshard(x, dim: int, n: int):
    """``x`` replicated on tensor dim ``dim`` over every mesh dim that
    shards it and whose size does not divide ``n``."""
    return replicate_where(x, lambda i, pl: pl.is_shard(dim) and n % x.device_mesh.size(i))


class _OnGrad(torch.autograd.Function):
    """The identity, whose gradient goes through ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _unshard_inner(x):
    """``x`` replicated on every dim between its first and its last (the
    dims a product flattens into rows beside the batch)."""
    return replicate_where(x, lambda i, pl: pl.is_shard() and 0 < pl.dim % x.dim() < x.dim() - 1)


def matmul_rows(x, w):
    """``x @ w`` for ``x`` [..., K] and a [K, N] ``w``. On a ``DTensor`` the
    product flattens x's leading dims into rows, which DTensor refuses (or,
    in newer versions, makes a strided shard whose redistributions it plans
    by a search) where a dim after the first is sharded: a sequence-sharded
    stream. So those dims are replicated first, in x and in the output's
    gradient alike (the all-gather of Megatron's sequence parallelism)."""
    if not is_dtensor(x) or x.dim() < 3:
        return x @ w
    return _OnGrad.apply(_unshard_inner(x) @ w, _unshard_inner)


def split_dim(x, dim: int, sizes: tuple[int, ...]):
    """``x`` with dim ``dim`` viewed as ``sizes`` (a projection's output as
    heads). A ``DTensor`` sharded on that dim over a mesh dim whose size
    does not divide ``sizes[0]`` is replicated on it first: DTensor refuses
    the uneven view (hymba's 5 heads over a model axis of 2) where GSPMD
    pads."""
    dim = dim % x.dim()
    x = _unshard(x, dim, sizes[0])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def merge_dims(x, dim: int):
    """``x`` with dims ``dim`` and ``dim + 1`` merged into one (heads back
    into a projection's input). On a ``DTensor`` the gradient, which
    autograd views back to the two dims, is replicated on the merged dim
    first where its sharding would split ``x.shape[dim]`` unevenly."""
    dim, n = dim % x.dim(), x.shape[dim]
    out = x.flatten(dim, dim + 1)
    return _OnGrad.apply(out, lambda g: _unshard(g, dim, n)) if is_dtensor(out) else out


def _with_partial(spec: Spec, partial_over: tuple[str, ...]) -> list:
    mesh = get_context().mesh
    return [Partial() if name in partial_over else pl
            for name, pl in zip(mesh.mesh_dim_names, placements(spec, mesh))]


def to_local(x, spec: Spec, *, partial_over: tuple[str, ...] = ()):
    """This process's piece of ``x`` once placed by ``spec`` on the context's
    mesh (:func:`constrain`; a plain tensor is cut), for code that runs on
    local tensors (the reference's ``shard_map``). Its gradient is declared
    placed as ``spec``, except a partial sum over the mesh axes
    ``partial_over``: those along which each process computed from its
    piece alone, whose gradients the backward then reduces."""
    if not is_dtensor(x):        # a plain tensor counts as replicated: cut its piece
        mesh = get_context().mesh
        return local_chunk(x, placements(spec, mesh), mesh)
    return constrain(x, spec).to_local(grad_placements=_with_partial(spec, partial_over))


def from_local(t: torch.Tensor, spec: Spec, shape, *, partial_over: tuple[str, ...] = ()):
    """The ``DTensor`` of global ``shape`` whose piece on this process is
    ``t``, placed by ``spec`` on the context's mesh, and a partial sum over
    the mesh axes ``partial_over`` (:func:`to_local`'s inverse)."""
    return DTensor.from_local(t.contiguous(), get_context().mesh,
                              _with_partial(spec, partial_over),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def replicated_value(x):
    """A replicated ``DTensor``'s value as a plain tensor (a loss, a norm);
    a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x
