"""Dry run of the distribution layer, and its roofline terms. Port of
``repro.launch.dryrun``.

Proves the distribution config is coherent without hardware: for every
(architecture x input-shape) cell, the cell's step (a train step, a
prefill, a decode step) must run on the 16 x 16 single-pod mesh AND the
2 x 16 x 16 multi-pod mesh, and its counts feed the roofline terms
(``distributed/roofline.py``, the H100 SXM's constants: a model, not a
measurement).

The reference lowers and compiles each step for 512 placeholder CPU
devices and reads XLA's artifacts. The port has no compiler to ask, so it
runs the step itself, as rank 0 of a world of 256 (512) ranks in this one
process: torch's ``fake`` process group, on which every collective returns
at once, and ``meta`` tensors, which carry shapes and dtypes and no data.
Nothing is allocated and no device is used; the world is set up by
:func:`run_cell` / :func:`run_cost_cell` (never at import), the mesh by
``launch.mesh.make_production_mesh(device_type="cpu")``, and
:func:`build_cell` installs the distribution context, as the reference's
does. Every leaf is a ``DTensor`` whose local shard is a meta tensor,
placed by the production specs (``distributed/sharding.py``), and every
step runs under ``implicit_replication``.

What a cell reports, in place of XLA's artifacts:

* **Collectives**: recorded one by one by the dispatch mode that counts
  FLOPs (:class:`_Counter`) where ``CommDebugMode`` counts them, at each
  ``_c10d_functional`` op DTensor issues on the local shards: its kind
  (all-gather, all-reduce, reduce-scatter, all-to-all), its operand and
  result bytes, and its group's size, read from the op's group.
  ``roofline.CollectiveStats.add`` applies the reference's ring-model
  factors. The cost pass also runs under ``CommDebugMode`` and fails
  unless its counts equal the record's (:func:`_check_comm`); the scan
  passes do without it (it triples a cell's time: its module tracker and
  fake-mode check on every op). On the ``cpu`` device type DTensor runs
  an all-to-all (a shard-to-shard redistribution) as an all-gather plus a
  chunk of it; the H100's NCCL mesh runs the all-to-all. Such an
  all-gather (one issued from DTensor's ``shard_dim_alltoall``) is
  counted as the all-to-all it stands for, with the all-gather's input as
  its operand: the collective term models the target's program.
  ``CommDebugMode``'s count of all-gathers is then the two kinds'
  together.
* **FLOPs per rank**: ``torch.utils.flop_counter``'s formulas applied to
  the local shards of each op, below DTensor (the counting mode defers a
  ``DTensor`` op to DTensor and counts the local ops it runs), so each
  rank's share, not the global product that ``FlopCounterMode`` above
  DTensor counts. DTensor's sharding propagation runs ops on fake tensors
  to infer shapes; those are not counted.
* **Bytes accessed per rank**: every dispatched local op's input and
  output bytes (XLA's definition at op granularity), views, allocations
  and collectives excluded.
* **Memory per rank**: the argument bytes are the local shards of the
  step's arguments (params, optimizer state, batch or cache), exact; the
  temporaries' peak is tracked by the counting mode on the meta storages
  themselves (each new storage's bytes counted live until a finalizer on
  it runs), which works with no data behind them. ``fits_80gb`` holds
  their sum against one H100's 80 GB.

The cost pass (:func:`run_cost_cell`) keeps the reference's layer pair
and its linear extrapolation to full depth. The reference's scan pass
compiles the whole stack as one scanned layer, so depth costs it
nothing; here the layers are a Python loop and every op of every layer
and microbatch runs (a per-token recurrence is ~0.6 ms an op on meta
tensors), so the scan pass (:func:`run_cell`: the production
microbatches and KV blocks) runs a layer pair too, one layer and two
(vision: one group of 5 and two; :func:`_scan_pair`), and extrapolates
its terms and its peak of temporaries the same way; its argument bytes
are the full depth's. ``--unroll`` runs the cost pass's settings at the
full depth itself.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k --cost
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out reports/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.distributed import roofline
from repro_torch.distributed.context import clear_context, set_context
from repro_torch.distributed.sharding import (MeshRules, batch_specs, cache_specs,
                                              fixup_divisibility, fixup_tree, is_dtensor,
                                              param_specs, placements, shard_range)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model, input_specs, needs_source
from repro_torch.models.config import shape_applicable
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step
from repro_torch.tree import tree_map

# The functional collectives' names (``_c10d_functional`` and its autograd
# twin) and the reference's kinds.
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
_FUNCOL = ("_c10d_functional", "_c10d_functional_autograd")
_NOT_WORK = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
             "wait_tensor", "_wrap_tensor_autograd")


# ---------------------------------------------------------------------------
# The world and the counting mode
# ---------------------------------------------------------------------------

def _production_mesh(multi_pod: bool):
    """The production mesh over a ``fake`` world of 256 (512) ranks in this
    process, this process rank 0; a world of another size is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _from_alltoall() -> bool:
    """Whether the collective being dispatched was issued by DTensor's
    ``shard_dim_alltoall`` (its all-gather + chunk fallback on ``cpu``)."""
    f = sys._getframe(2)
    for _ in range(8):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


class _Counter(TorchDispatchMode):
    """Counts, op by op on the local shards, FLOPs, bytes accessed, live
    bytes of new storages and collectives. A ``DTensor`` op is deferred to
    DTensor (``NotImplemented``); the local ops DTensor then runs come back
    here, as ``CommDebugMode`` sees them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.stats = roofline.CollectiveStats()
        self.from_alltoall = 0
        self._seen: set[int] = set()

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.discard(key)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key, st.nbytes())
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            return out          # DTensor's shape propagation, not the rank's work
        ns, name = func._schema.name.split("::")
        if ns in _FUNCOL and name in _KINDS:
            kind = _KINDS[name]
            if kind == "all-gather" and _from_alltoall():
                kind = "all-to-all"
                self.from_alltoall += 1
            group = _resolve_process_group(args[-1] if isinstance(args[-1], str)
                                           else kwargs["group_name"])
            operand = _nbytes(args[0])
            self.stats.add(kind, operand, operand if kind == "all-to-all" else _nbytes(out),
                           group.size())
        elif name not in _NOT_WORK and not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            if func._overloadpacket in self.flop_registry:
                self.flops += self.flop_registry[func._overloadpacket](*args, **kwargs,
                                                                       out_val=out)
            self._track(out)
        return out


def _run_counted(fn, args, *, train: bool, comm_check: bool) -> _Counter:
    """``fn(*args)`` under the counting mode (the serving steps without
    autograd), and with ``comm_check`` under ``CommDebugMode`` too, whose
    counts must equal the counter's: the counter."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    grad = contextlib.nullcontext() if train else torch.no_grad()
    counter = _Counter()
    comm = CommDebugMode() if comm_check else contextlib.nullcontext()
    with comm, counter, implicit_replication(), grad:
        out = fn(*args)
    del out
    if comm_check:
        _check_comm(comm, counter)
    return counter


def _check_comm(comm, counter: _Counter) -> None:
    """``CommDebugMode``'s counts by kind against the counter's (an
    all-to-all counted from an all-gather is an all-gather there)."""
    by_kind: dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = _KINDS.get(str(op).split(".")[-1], str(op))
        by_kind[kind] = by_kind.get(kind, 0) + n
    mine = dict(counter.stats.op_counts)
    if counter.from_alltoall:
        mine["all-gather"] = mine.get("all-gather", 0) + counter.from_alltoall
        mine["all-to-all"] -= counter.from_alltoall
    mine = {k: v for k, v in mine.items() if v}
    if mine != by_kind:
        raise RuntimeError(f"collectives: CommDebugMode counted {by_kind}, the dry run {mine}")


# ---------------------------------------------------------------------------
# Step builders: one unit per shape kind
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _param_shapes(cfg, serve: bool) -> dict:
    """``{path: (shape, dtype)}`` of the params tree: ``init_params`` under
    ``FakeTensorMode`` (the reference's ``jax.eval_shape``). Serving stores
    float32 leaves of 2 or more dims in the compute dtype, and quantizes a
    ``w4a8_serve`` config's projections, as the reference's cell does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cdt = getattr(torch, cfg.compute_dtype)
    if serve and not cfg.w4a8_serve:        # the training tree's shapes, cast
        return tree_map(lambda sd: (sd[0], cdt) if sd[1] == torch.float32 and len(sd[0]) >= 2
                        else sd, _param_shapes(cfg, False))
    with FakeTensorMode():
        params = build_model(cfg, device="cpu").init_params(0)
        if serve:
            from repro_torch.models.quantized import quantize_params
            params = quantize_params(tree_map(
                lambda t: t.to(cdt) if t.dtype == torch.float32 and t.dim() >= 2 else t, params))
        return tree_map(lambda t: (tuple(t.shape), t.dtype), params)


def _is_leaf_spec(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple)


def _placed(shapes: dict, specs: dict, mesh) -> dict:
    """Meta ``DTensor`` s of the ``(shape, dtype)`` leaves of ``shapes``,
    zeros, each placed by its spec: the local shard made directly, so no
    full-size tensor is ever made."""
    out = {}
    for k, v in shapes.items():
        if not _is_leaf_spec(v):
            out[k] = _placed(v, specs[k], mesh)
            continue
        shape, dtype = v
        pls = placements(specs[k], mesh)
        local = [shard_range(n, pls, mesh, d)[1] for d, n in enumerate(shape)]
        t = torch.zeros(local, dtype=dtype, device="meta")
        out[k] = DTensor.from_local(t, mesh, pls, run_check=False, shape=torch.Size(shape),
                                    stride=torch.empty(shape, device="meta").stride())
    return out


def build_cell(cfg, shape, mesh, *, microbatches: int = 1, train_opts: dict | None = None):
    """``(step, args)``: the cell's step and its arguments, every leaf a
    meta ``DTensor`` placed by its spec. Installs the distribution context
    of ``mesh``."""
    rules = MeshRules(mesh)
    set_context(mesh, batch_axes=rules.batch_axes, model_axis="model")
    model = build_model(cfg, device="meta")
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        # f32 masters (the optimizer state) cast at use
        pshapes = _param_shapes(cfg, serve=False)
        pspec = param_specs(pshapes, rules, train=True)
        params = _placed(pshapes, pspec, mesh)
        bspecs = fixup_tree(batch_specs(cfg, shape, rules), specs, mesh)
        step = make_train_step(model, microbatches=microbatches, param_specs=pspec,
                               **(train_opts or {}))
        return step, (params, adamw_init(params), _placed(specs, bspecs, mesh))

    pshapes = _param_shapes(cfg, serve=True)
    params = _placed(pshapes, param_specs(pshapes, rules, train=False), mesh)
    src_len = cfg.source_len if needs_source(cfg) else None
    if shape.kind == "prefill":
        b, s = shape.global_batch, shape.seq_len
        cshapes = {k: (tuple(v.shape), v.dtype)
                   for k, v in model.init_cache(b, s, src_len).items()}
        cspec = fixup_tree(cache_specs(cfg, shape, rules), cshapes, mesh)
        bspecs = fixup_tree(batch_specs(cfg, shape, rules), specs, mesh)

        def prefill_step(params, batch):
            # the cache made in the step, placed by its specs (the
            # reference's init_cache + with_sharding_constraint)
            cache = _placed(cshapes, cspec, mesh)
            return model.prefill(params, batch["tokens"], cache, batch.get("source"))

        return prefill_step, (params, _placed(specs, bspecs, mesh))

    # decode: serve_step, one token for every sequence in the batch
    cspec = fixup_tree(cache_specs(cfg, shape, rules), specs["cache"], mesh)
    tok_spec = fixup_divisibility(batch_specs(cfg, shape, rules)["tokens"],
                                  specs["tokens"][0], mesh)

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    return serve_step, (params, _placed({"t": specs["tokens"]}, {"t": tok_spec}, mesh)["t"],
                        _placed(specs["cache"], cspec, mesh))


def argument_bytes(args) -> int:
    """The local bytes of a cell's arguments on this rank."""
    return _nbytes([t.to_local() if is_dtensor(t) else t for t in _tensors(args)])


# ---------------------------------------------------------------------------
# One cell: run + count + analyze
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool, reduced: bool = False,
             microbatches: int | None = None, unroll: bool = False,
             overrides: dict | None = None) -> dict:
    """The production program of one cell (the reference's scan pass): its
    microbatches and KV blocks, run at the layer pair of
    :func:`_layer_pair` and extrapolated linearly to the full depth, as the
    cost pass is; the argument bytes are those of the full depth, exact.
    ``unroll``: the cost pass's settings (one KV block, no microbatches)
    run at the full depth itself."""
    cfg = get_config(arch, reduced=reduced)
    shape = SHAPES[shape_name]
    ov = dict(overrides or {})
    if unroll:
        ov.setdefault("attn_block", shape.seq_len)
    cfg = cfg.replace(unroll_layers=unroll, **ov)
    if microbatches is None:
        microbatches = 1 if unroll else (8 if shape.kind == "train" else 1)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    report = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind, "mode": "unroll" if unroll else "scan",
              "microbatches": microbatches, "ok": False}

    runs, reason = shape_applicable(cfg, shape)
    if not runs:
        report.update(skipped=True, reason=reason, ok=True)
        return report

    try:
        mesh = _production_mesh(multi_pod)
        n_chips = mesh.size()
        t0 = time.perf_counter()
        _, args = build_cell(cfg, shape, mesh, microbatches=microbatches)
        arg_bytes = argument_bytes(args)
        del args
        if unroll:
            c = _extract_costs(cfg, shape, mesh, microbatches=microbatches)
        else:
            l_small, l_big, l_full = _scan_pair(cfg)
            report["layer_pair"] = [l_small, l_big, l_full]
            c = _extrapolate(
                *(_extract_costs(_cfg_with_layers(cfg, n), shape, mesh,
                                 microbatches=microbatches) for n in (l_small, l_big)),
                *_denoms(cfg, l_small, l_big, l_full))
        wall = time.perf_counter() - t0
        stats = roofline.CollectiveStats(op_bytes=c["op_bytes"], op_counts=c["op_counts"],
                                         ici_bytes=c["ici_bytes"])
        bytes_per_chip = arg_bytes + c["peak"]
        rep = roofline.analyze(
            arch, shape_name, mesh_name, n_chips,
            {"flops": c["chip_flops"], "bytes accessed": c["global_bytes"] / n_chips},
            stats, bytes_per_chip=bytes_per_chip,
            model_flops=roofline.model_flops_for_cell(cfg, shape))
        report.update(
            ok=True, run_s=round(wall, 2),
            memory={"argument_gb": arg_bytes / 1e9, "temp_gb": c["peak"] / 1e9,
                    "per_chip_gb": bytes_per_chip / 1e9,
                    "fits_80gb": bytes_per_chip < 80e9},
            roofline={**rep.row(), "global_gflops": c["chip_flops"] * n_chips / 1e9},
        )
    except Exception as e:  # a failure here is a fault of the sharded program
        report.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-3000:])
    finally:
        clear_context()
    return report


def print_report(rep: dict):
    if rep.get("skipped"):
        print(f"[SKIP] {rep['arch']} x {rep['shape']} ({rep['mesh']}): {rep['reason']}")
        return
    if not rep["ok"]:
        print(f"[FAIL] {rep['arch']} x {rep['shape']} ({rep['mesh']}): {rep['error']}")
        return
    m, r = rep["memory"], rep["roofline"]
    print(f"[ OK ] {rep['arch']} x {rep['shape']} ({rep['mesh']} "
          f"{rep.get('mode', 'scan')}) run={rep.get('run_s', '-')}s")
    if "argument_gb" in m:
        print(f"       mem/chip={m['per_chip_gb']:.2f} GB "
              f"(args={m['argument_gb']:.2f} temp={m['temp_gb']:.2f}; "
              f"fits 80GB: {m['fits_80gb']})")
    print(f"       t_compute={r['t_compute_ms']:.3f}ms "
          f"t_memory={r['t_memory_ms']:.3f}ms "
          f"t_collective={r['t_collective_ms']:.3f}ms "
          f"-> {r['dominant']}-bound; useful={100 * r['useful_frac']:.1f}% "
          f"roofline={100 * r['roofline_frac']:.1f}%")
    print(f"       collectives: {r['op_counts']}")


# ---------------------------------------------------------------------------
# Cost pass via layer-pair extrapolation
# ---------------------------------------------------------------------------

def _layer_pair(cfg) -> tuple[int, int, int]:
    """(L_small, L_big, L_full) preserving the arch's layer-group structure."""
    if cfg.cross_attn_every > 1:                 # vlm: groups of N layers
        g = cfg.cross_attn_every
        return g, 2 * g, cfg.n_layers
    return 2, 4, cfg.n_layers


def _scan_pair(cfg) -> tuple[int, int, int]:
    """The scan pass's pair: the smallest that keeps the layer-group
    structure (one layer and two; vision's one group and two), half the
    cost pass's, since the scan pass runs every microbatch."""
    g = cfg.cross_attn_every if cfg.cross_attn_every > 1 else 1
    return g, 2 * g, cfg.n_layers


def _cfg_with_layers(cfg, n_layers: int):
    kw = {"n_layers": n_layers}
    if cfg.encoder_layers:
        kw["encoder_layers"] = n_layers
    return cfg.replace(**kw)


def _extract_costs(cfg, shape, mesh, microbatches=1, train_opts=None, comm_check=False):
    fn, args = build_cell(cfg, shape, mesh, microbatches=microbatches, train_opts=train_opts)
    counter = _run_counted(fn, args, train=shape.kind == "train", comm_check=comm_check)
    return {
        "chip_flops": float(counter.flops),
        "global_bytes": float(counter.bytes) * mesh.size(),
        "ici_bytes": counter.stats.ici_bytes,
        "op_counts": dict(counter.stats.op_counts),
        "op_bytes": dict(counter.stats.op_bytes),
        "peak": float(counter.peak),
    }


def _denoms(cfg, l_small: int, l_big: int, l_full: int) -> tuple[int, int, int]:
    """The layer counts the extrapolation scales by: an encoder-decoder
    scales both stacks, so its layers count twice."""
    k = 2 if cfg.encoder_layers else 1
    return l_small * k, l_big * k, l_full * k


def _extrapolate(c_small: dict, c_big: dict, denom_small: int, denom_big: int,
                 denom_full: int) -> dict:
    """The costs of the full depth, linear in the layer count through the
    small and the big runs' (counts rounded to integers)."""
    def extrap(key):
        delta = (c_big[key] - c_small[key]) / (denom_big - denom_small)
        return c_big[key] + delta * (denom_full - denom_big)

    scale_counts = (denom_full - denom_big) / (denom_big - denom_small)

    def extrap_dict(key):
        return {k: c_big[key].get(k, 0) + (c_big[key].get(k, 0) - c_small[key].get(k, 0))
                * scale_counts for k in set(c_big[key]) | set(c_small[key])}

    out = {k: extrap(k) for k in ("chip_flops", "global_bytes", "ici_bytes", "peak")}
    out["op_counts"] = {k: int(round(v)) for k, v in extrap_dict("op_counts").items()}
    out["op_bytes"] = extrap_dict("op_bytes")
    return out


def run_cost_cell(arch: str, shape_name: str, *, reduced: bool = False,
                  overrides: dict | None = None,
                  train_opts: dict | None = None) -> dict:
    """Roofline COST extraction: a single KV block and no microbatches, run
    at a small/big layer pair and extrapolated linearly to the full depth
    (per-layer cost is L-independent for these homogeneous stacks), as the
    reference's."""
    cfg0 = get_config(arch, reduced=reduced)
    shape = SHAPES[shape_name]
    report = {"arch": arch, "shape": shape_name, "mesh": "16x16",
              "kind": shape.kind, "mode": "unroll-extrap", "ok": False}
    runs, reason = shape_applicable(cfg0, shape)
    if not runs:
        report.update(skipped=True, reason=reason, ok=True)
        return report

    ov = dict(overrides or {})
    ov.setdefault("attn_block", shape.seq_len)
    ov.setdefault("unroll_layers", True)
    cfg = cfg0.replace(**ov)
    l_small, l_big, l_full = _layer_pair(cfg)

    try:
        mesh = _production_mesh(False)
        t0 = time.perf_counter()
        c_small, c_big = (_extract_costs(_cfg_with_layers(cfg, n), shape, mesh,
                                         train_opts=train_opts, comm_check=True)
                          for n in (l_small, l_big))
        wall = time.perf_counter() - t0
        c = _extrapolate(c_small, c_big, *_denoms(cfg, l_small, l_big, l_full))

        n_chips = mesh.size()
        rep = roofline.RooflineReport(
            arch=arch, shape=shape_name, mesh="16x16", n_chips=n_chips,
            hlo_flops=c["chip_flops"], hlo_bytes=c["global_bytes"] / n_chips,
            collective_op_bytes=0, collective_ici_bytes=c["ici_bytes"],
            bytes_per_chip=0.0,
            model_flops=roofline.model_flops_for_cell(cfg0, shape),
            op_counts=c["op_counts"]).finalize()
        report.update(ok=True, run_s=round(wall, 2),
                      layer_pair=[l_small, l_big, l_full],
                      memory={"per_chip_gb": float("nan"), "fits_80gb": None},
                      roofline=rep.row(),
                      op_gbytes={k: round(v / 1e9, 3) for k, v in c["op_bytes"].items()})
    except Exception as e:
        report.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-3000:])
    finally:
        clear_context()
    return report


# ---------------------------------------------------------------------------
# --all: every cell in a fresh subprocess (memory isolation)
# ---------------------------------------------------------------------------

def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]


def run_all(out_dir: Path, *, reduced: bool, timeout: int = 3600,
            archs=None, shapes=None):
    """Three passes per cell: (16x16, scan), (2x16x16, scan) — the multi-pod
    proof — and the 16x16 cost pass (the roofline-term extraction)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    passes = [(False, False), (True, False), (False, True)]  # (mp, cost)
    for arch, shape in all_cells():
        if archs and arch not in archs:
            continue
        if shapes and shape not in shapes:
            continue
        for mp, cost in passes:
            tag = (f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                   f"{'__unroll' if cost else ''}")
            fout = out_dir / f"{tag}.json"
            if fout.exists():
                rep = json.loads(fout.read_text())
                if rep.get("ok"):
                    results.append(rep)
                    print(f"[CACHED] {tag}")
                    continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--json", str(fout)]
            if mp:
                cmd.append("--multi-pod")
            if cost:
                cmd.append("--cost")   # layer-pair extrapolated cost pass
            if reduced:
                cmd.append("--reduced")
            t0 = time.perf_counter()
            fail = {"arch": arch, "shape": shape, "ok": False,
                    "mesh": "2x16x16" if mp else "16x16",
                    "mode": "unroll-extrap" if cost else "scan"}
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
                rep = (json.loads(fout.read_text()) if fout.exists() else
                       {**fail, "error": proc.stderr[-2000:]})
            except subprocess.TimeoutExpired:
                rep = {**fail, "error": f"timeout after {timeout}s"}
                fout.write_text(json.dumps(rep, indent=1))
            rep.setdefault("wall_s", round(time.perf_counter() - t0, 1))
            results.append(rep)
            print_report(rep)
    summarize(results, out_dir)
    return results


def summarize(results: list[dict], out_dir: Path):
    ok = sum(1 for r in results if r.get("ok") and not r.get("skipped"))
    skip = sum(1 for r in results if r.get("skipped"))
    fail = sum(1 for r in results if not r.get("ok"))
    print(f"\n=== dry-run summary: {ok} ok, {skip} skipped, {fail} failed "
          f"of {len(results)} ===")
    (out_dir / "summary.json").write_text(json.dumps(results, indent=1))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="architecture id (e.g. qwen3-8b)")
    ap.add_argument("--shape", choices=list(SHAPES), help="input-shape cell")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 ranks) instead of 16x16 (256)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs (machinery smoke test)")
    ap.add_argument("--unroll", action="store_true",
                    help="full-depth cost pass (one KV block, no microbatches)")
    ap.add_argument("--cost", action="store_true",
                    help="layer-pair extrapolated cost pass (fast)")
    ap.add_argument("--override", nargs="*", default=[],
                    help="cost pass: ModelConfig overrides, k=v (hillclimb)")
    ap.add_argument("--bf16-gather", action="store_true",
                    help="cost pass: bf16 FSDP all-gathers (hillclimb)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--json", help="write the cell report to this path")
    ap.add_argument("--out", default="reports/dryrun_torch",
                    help="--all: output directory")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--archs", nargs="*", help="--all: restrict archs")
    ap.add_argument("--shapes", nargs="*", help="--all: restrict shapes")
    args = ap.parse_args()

    if args.all:
        results = run_all(Path(args.out), reduced=args.reduced, timeout=args.timeout,
                          archs=args.archs, shapes=args.shapes)
        sys.exit(0 if all(r.get("ok") for r in results) else 1)

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    overrides = {}
    for kv in (args.override or []):
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        elif v.lstrip("-").isdigit():
            v = int(v)
        overrides[k] = v
    topts = {"bf16_gather": True} if args.bf16_gather else None
    if args.cost:
        rep = run_cost_cell(args.arch, args.shape, reduced=args.reduced,
                            overrides=overrides, train_opts=topts)
    else:
        rep = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       reduced=args.reduced, microbatches=args.microbatches,
                       unroll=args.unroll, overrides=overrides)
    print_report(rep)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rep, indent=1))
    sys.exit(0 if rep["ok"] else 1)


if __name__ == "__main__":
    main()
