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
placements of a mesh (``named``'s counterpart). Non-divisible dims fall
back to replicated (:func:`fixup_divisibility`).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.tree import tree_items

from .context import mesh_shape

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
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, name in enumerate(spec)
                    if name == axis or (isinstance(name, tuple) and axis in name)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out
