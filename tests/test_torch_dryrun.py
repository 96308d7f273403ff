"""The dry run (``repro_torch.launch.dryrun``) against the reference's
``repro.launch.dryrun`` and ``repro.distributed.roofline``.

Three subprocesses, started together when the module's first test runs:
the port's on a ``fake`` world of 256 and then 512 ranks (no process group
may stay in a pytest worker), the reference's dry-run module, which
rewrites ``XLA_FLAGS`` when imported (a later subprocess of the same
worker would inherit them), and the port's reduced MoE cells. The cases:

* ``all_cells``, the skip reports, ``_layer_pair`` and
  ``_cfg_with_layers`` equal the reference's, for all 12 configs;
* ``roofline.CollectiveStats.add`` over a list of (kind, operand bytes,
  result bytes, group size) equals the reference's ``parse_collectives``
  on HLO text made from the same list (one as a ``-start``/``-done``
  pair), and ``roofline.analyze``'s row equals the reference's in every
  field that does not read the hardware constants;
* the per-rank argument bytes of every applicable cell of the 10 assigned
  configs, on both meshes, equal the bytes of the local shards that the
  reference's ``param_specs`` / ``batch_specs`` / ``cache_specs`` cut
  from its ``jax.eval_shape`` leaves on fake 16 x 16 and 2 x 16 x 16
  meshes (params, the AdamW state and the batch to train; params and the
  tokens to prefill; params, tokens and the cache to decode);
* FLOPs per rank: x[32,128,4096] placed (Shard(0), Replicate()) times
  W[4096,11008] placed (Shard(0), Shard(1)) on 16 x 16 costs
  2·2·128·4096·688 = 1.4428 GFLOP on a rank, 369.37 GFLOP in all
  (``FlopCounterMode`` above DTensor);
* a shard-to-shard redistribution over the model axis is counted as one
  all-to-all of the local shard's bytes (DTensor runs it on the ``cpu``
  device type as an all-gather and a chunk; the dry run counts the
  all-to-all the H100's NCCL mesh runs), and ``CommDebugMode`` counts an
  all-gather;
* ``run_cost_cell`` at full width is ``ok`` for qwen3-8b decode_32k,
  whisper-small train_4k (the reference test's pair) and olmoe-1b-7b
  train_4k; its report has the reference's keys (``compile_s`` is
  ``run_s``: the port runs the step, it compiles nothing), its
  ``model_gflops`` the reference's, and its ``useful_frac`` lies in a
  band derived from the model FLOPs M = 6·N·D (train) or 2·N·B +
  attention (decode), N the active params, v·d the embedding table:

  - decode: the program's matmuls are the model's but the embedding
    lookup (a gather, where M counts 2·v·d a token), so useful_frac =
    M / (M − 2·v·d·B), within 2% (the norms and softmax are no matmuls);
  - train: at most 0.75 · M / (M − 6·v·d·D) (remat runs every layer's
    forward twice, 8 FLOPs a parameter and token where M counts 6; the
    lookup again), and at least half of M / W, W the worst case of the
    sharded program's matmuls: c·(8/6)·(M − 6·v·d·D) for the layers (the
    experts padded to the capacity factor c), r_v·6·v·d·D for the
    unembed, r_a·A for attention, A = 16·B·H·dh·(L·S² + the encoder's and
    the cross terms) (forward, remat and backward of the S x S scores and
    their product with V, no causal skip at a single KV block), and
    whisper's cross projections 8·B·L·d²·(2·S + 2·S_src), with r = 16 (all
    ranks of the model axis) where the vocab or the head count does not
    divide it (whisper-small's 51865 and 12), else 1; the half leaves room
    for the matmuls M does not model (MoE routing and dispatch).
* the reduced olmoe-1b-7b and llama4-scout-17b-a16e cells train_4k and
  prefill_32k (``run_cell(..., reduced=True)``, ~3-13 s each) are ``ok``:
  their 8 and 4 experts do not divide the model axis of 16, so the
  capacity MoE takes its global route on ``DTensor`` s.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import roofline as jax_roofline
from repro.distributed import sharding as jax_sharding
from repro.models.api import build_model as jax_build_model
from repro.models.api import input_specs as jax_input_specs
from repro.models.quantized import quantize_params as jax_quantize_params
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.distributed import roofline
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parent.parent
COST_CELLS = [("qwen3-8b", "decode_32k"), ("whisper-small", "train_4k"),
              ("olmoe-1b-7b", "train_4k")]
# reduced MoE cells whose experts (8, 4) do not divide the model axis of 16:
# the capacity MoE's global route on DTensors
REDUCED_MOE_CELLS = [("olmoe-1b-7b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
                     ("llama4-scout-17b-a16e", "train_4k"),
                     ("llama4-scout-17b-a16e", "prefill_32k")]
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}

_PORT = r"""
import json, sys
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun

out = {"arg_bytes": {}, "cost": {}}
for mp in (False, True):
    mesh = dryrun._production_mesh(mp)
    for arch, name in dryrun.all_cells():
        cfg, shape = get_config(arch), SHAPES[name]
        if shape_applicable(cfg, shape)[0]:
            _, args = dryrun.build_cell(cfg, shape, mesh)
            out["arg_bytes"][f"{arch}|{name}|{'2x16x16' if mp else '16x16'}"] = \
                dryrun.argument_bytes(args)
            del args
    dryrun.clear_context()

mesh = dryrun._production_mesh(False)
def placed(local, shape, pls):
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())
x = placed((2, 128, 4096), (32, 128, 4096), [Shard(0), Replicate()])
w = placed((256, 688), (4096, 11008), [Shard(0), Shard(1)])
c = dryrun._run_counted(lambda: x @ w, (), train=False, comm_check=True)
with FlopCounterMode(display=False) as f:
    x @ w
out["probe"] = {"rank": c.flops, "global": f.get_total_flops()}

t = placed((16, 256), (256, 256), [Replicate(), Shard(0)])
c = dryrun._run_counted(lambda: t.redistribute(mesh, [Replicate(), Shard(1)]), (),
                        train=False, comm_check=True)
out["alltoall"] = {"counts": c.stats.op_counts, "bytes": c.stats.op_bytes,
                   "ici": c.stats.ici_bytes, "from_alltoall": c.from_alltoall}

for arch, name in json.loads(sys.argv[1]):
    out["cost"][f"{arch}|{name}"] = dryrun.run_cost_cell(arch, name)
print(json.dumps(out))
"""

_REDUCED = r"""
import json, sys
from repro_torch.launch import dryrun

print(json.dumps({f"{arch}|{name}": dryrun.run_cell(arch, name, multi_pod=False, reduced=True)
                  for arch, name in json.loads(sys.argv[1])}))
"""

_REF = r"""
import dataclasses, json, sys
from repro.launch import dryrun     # first: it sets XLA_FLAGS before jax starts
from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable

pairs = {}
for a in ARCH_IDS:
    cfg = get_config(a)
    pairs[a] = {"pair": dryrun._layer_pair(cfg),
                "with": {n: dataclasses.asdict(dryrun._cfg_with_layers(cfg, n))
                         for n in dryrun._layer_pair(cfg)}}
skips = {}
for arch, name in dryrun.all_cells():
    if shape_applicable(get_config(arch), SHAPES[name])[0]:
        continue                      # an applicable cell would be compiled at full size
    for mp in (False, True):
        skips[f"{arch}|{name}|{mp}"] = dryrun.run_cell(arch, name, multi_pod=mp)
    skips[f"{arch}|{name}|cost"] = dryrun.run_cost_cell(arch, name)
cost = dryrun.run_cost_cell("qwen3-8b", "decode_32k", reduced=True)
print(json.dumps({"all_cells": dryrun.all_cells(), "pairs": pairs, "skips": skips,
                  "cost_keys": sorted(cost), "row_keys": sorted(cost["roofline"])}))
"""


def _start(script: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", script, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """(the port's results, the reference's, the port's reduced MoE
    cells), the three subprocesses run side by side."""
    procs = (_start(_PORT, json.dumps(COST_CELLS)), _start(_REF),
             _start(_REDUCED, json.dumps(REDUCED_MOE_CELLS)))
    try:
        return tuple(_result(p) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_cells_pairs_and_skips_equal_the_reference(runs):
    _, ref, _ = runs
    assert [list(c) for c in dryrun.all_cells()] == ref["all_cells"]
    for arch in JAX_ARCH_IDS:
        cfg = get_config(arch)
        assert list(dryrun._layer_pair(cfg)) == ref["pairs"][arch]["pair"], arch
        for n, want in ref["pairs"][arch]["with"].items():
            assert dataclasses.asdict(dryrun._cfg_with_layers(cfg, int(n))) == want, (arch, n)
    n_skips = 0
    for key, want in ref["skips"].items():
        arch, name, mp = key.split("|")
        got = (dryrun.run_cost_cell(arch, name) if mp == "cost"
               else dryrun.run_cell(arch, name, multi_pod=mp == "True"))
        assert got == want, key
        n_skips += 1
    assert n_skips == 7 * 3               # long_500k on the 7 full-attention configs


def _hlo(ops: list[tuple[str, int, int, int]]) -> str:
    """Optimized-HLO-like text of ``ops``: each operand an f32 vector of its
    bytes / 4, the first one as an async ``-start`` / ``-done`` pair."""
    lines = ["HloModule m", "ENTRY %main {"]
    for i, (kind, ob, rb, n) in enumerate(ops):
        groups = f"replica_groups=[{256 // n},{n}]<=[256]"
        lines.append(f"  %p{i} = f32[{ob // 4}]{{0}} parameter({i})")
        op = f"{kind}-start" if i == 0 else kind
        lines.append(f"  %c{i} = f32[{rb // 4}]{{0}} {op}(f32[{ob // 4}]{{0}} %p{i}), "
                     f"{groups}, dimensions={{0}}")
        if i == 0:
            lines.append(f"  %d{i} = f32[{rb // 4}]{{0}} {kind}-done(f32[{rb // 4}]{{0}} %c{i})")
    lines.append("}")
    return "\n".join(lines)


OPS = [("all-gather", 4096, 65536, 16), ("all-reduce", 8192, 8192, 16),
       ("reduce-scatter", 65536, 4096, 16), ("all-to-all", 2048, 2048, 16),
       ("collective-permute", 1024, 1024, 2), ("all-reduce", 400, 400, 256),
       ("all-gather", 512, 1024, 2)]


def _stats() -> roofline.CollectiveStats:
    stats = roofline.CollectiveStats()
    for kind, ob, rb, n in OPS:
        stats.add(kind, ob, rb, n)
    return stats


def test_collective_stats_equal_parse_collectives():
    want = jax_roofline.parse_collectives(_hlo(OPS), default_group=16)
    got = _stats()
    assert got.op_counts == want.op_counts and got.op_bytes == want.op_bytes
    assert got.ici_bytes == want.ici_bytes
    assert got.total_operand_bytes == want.total_operand_bytes
    assert sum(want.op_counts.values()) == len(OPS)
    with pytest.raises(ValueError):
        got.add("all-scatter", 4, 4, 2)


def test_analyze_row_equals_the_reference():
    cost = {"flops": 3.5e12, "bytes accessed": 2.25e10}
    kw = dict(bytes_per_chip=4.5e10, model_flops=7.0e14)
    want = jax_roofline.analyze("qwen3-8b", "train_4k", "16x16", 256, cost, _hlo(OPS),
                                tp_size=16, **kw).row()
    got = roofline.analyze("qwen3-8b", "train_4k", "16x16", 256, cost, _stats(), **kw).row()
    hardware = {"t_compute_ms", "t_memory_ms", "t_collective_ms", "dominant", "roofline_frac"}
    assert got.keys() == want.keys()
    for k in got.keys() - hardware:
        assert got[k] == want[k], k


def _local_bytes(shapes, specs, mesh: dict) -> int:
    """The bytes of the local shards ``specs`` cut from ``shapes`` (the
    reference's trees of ``ShapeDtypeStruct`` and ``PartitionSpec``)."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes),
                          jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            div = int(np.prod([mesh[a] for a in names])) if names else 1
            assert dim % div == 0
            n *= dim // div
        total += n * leaf.dtype.itemsize
    return total


def _reference_arg_bytes(arch: str, name: str, mesh_name: str) -> int:
    shape_map = MESHES[mesh_name]

    class Mesh:
        shape = shape_map
        axis_names = tuple(shape_map)

    rules = jax_sharding.MeshRules(Mesh)
    jcfg, shape = jax_get_config(arch), JAX_SHAPES[name]
    specs = jax_input_specs(jcfg, shape)
    params = _param_shapes(arch, shape.kind == "train")
    pspec = jax_sharding.param_specs(params, rules, train=shape.kind == "train")
    total = _local_bytes(params, pspec, shape_map)
    if shape.kind == "train":
        opt = jax.eval_shape(jax_adamw_init, params)
        total += _local_bytes((opt.step, opt.mu, opt.nu),
                              (jax.sharding.PartitionSpec(), pspec, pspec), shape_map)
    if shape.kind in ("train", "prefill"):
        bspec = jax_sharding.fixup_tree(jax_sharding.batch_specs(jcfg, shape, rules), specs,
                                        Mesh)
        return total + _local_bytes(specs, bspec, shape_map)
    cspec = jax_sharding.fixup_tree(jax_sharding.cache_specs(jcfg, shape, rules),
                                    specs["cache"], Mesh)
    tspec = jax_sharding.fixup_divisibility(
        jax_sharding.batch_specs(jcfg, shape, rules)["tokens"], specs["tokens"].shape, Mesh)
    return (total + _local_bytes(specs["tokens"], tspec, shape_map)
            + _local_bytes(specs["cache"], cspec, shape_map))


_PARAMS: dict = {}


def _param_shapes(arch: str, train: bool):
    """The reference dry run's params: ``jax.eval_shape`` of
    ``init_params``; to serve, float32 leaves of 2 or more dims in the
    compute dtype (and W4A8-quantized where the config says)."""
    key = (arch, train)
    if key not in _PARAMS:
        jcfg = jax_get_config(arch)
        shapes = jax.eval_shape(jax_build_model(jcfg).init_params, jax.random.PRNGKey(0))
        if not train:
            cdt = np.dtype(jax.numpy.dtype(jcfg.compute_dtype))
            shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, cdt)
                                  if s.dtype == np.float32 and s.ndim >= 2 else s, shapes)
            if jcfg.w4a8_serve:
                shapes = jax.eval_shape(jax_quantize_params, shapes)
        _PARAMS[key] = shapes
    return _PARAMS[key]


def test_argument_bytes_equal_the_reference_specs(runs):
    port, *_ = runs
    n = 0
    for arch in ASSIGNED_ARCHS:
        for name, shape in SHAPES.items():
            if not shape_applicable(get_config(arch), shape)[0]:
                continue
            for mesh in MESHES:
                got = port["arg_bytes"][f"{arch}|{name}|{mesh}"]
                assert got == _reference_arg_bytes(arch, name, mesh), (arch, name, mesh)
                n += 1
    assert n == 2 * (len(ASSIGNED_ARCHS) * 3 + 3)


def test_flops_are_per_rank(runs):
    port, *_ = runs
    assert port["probe"]["rank"] == 2 * 2 * 128 * 4096 * 688           # 1.4428 GFLOP
    assert port["probe"]["global"] == 2 * 32 * 128 * 4096 * 11008      # 369.37 GFLOP
    assert round(port["probe"]["rank"] / 1e9, 4) == 1.4428
    assert round(port["probe"]["global"] / 1e9, 2) == 369.37


def test_cpu_alltoall_counts_as_the_alltoall(runs):
    """Shard(0) -> Shard(1) over the model axis of a [256, 256] float32:
    one all-to-all of the local 16 x 256 shard, (n-1)/n of it on the links;
    ``CommDebugMode`` saw the all-gather the ``cpu`` device type runs."""
    port, *_ = runs
    a = port["alltoall"]
    shard = 16 * 256 * 4
    assert a["counts"] == {"all-to-all": 1} and a["bytes"] == {"all-to-all": shard}
    assert a["ici"] == pytest.approx(15 / 16 * shard, rel=1e-12)
    assert a["from_alltoall"] == 1


def _useful_band(arch: str, name: str) -> tuple[float, float]:
    cfg, shape = get_config(arch), SHAPES[name]
    m = roofline.model_flops_for_cell(cfg, shape)
    vd = cfg.vocab_size * cfg.d_model
    if shape.kind == "decode":
        want = m / (m - 2 * vd * shape.global_batch)
        return want * 0.98, want * 1.02
    tokens, b, s = shape.global_batch * shape.seq_len, shape.global_batch, shape.seq_len
    attn = cfg.n_layers * s * s
    cross = 0
    if cfg.encoder_layers:
        attn += cfg.encoder_layers * cfg.source_len ** 2 + cfg.n_layers * s * cfg.source_len
        cross = 8 * b * cfg.n_layers * cfg.d_model ** 2 * (2 * s + 2 * cfg.source_len)
    a = 16 * b * cfg.n_heads * cfg.resolved_head_dim * attn
    rep = lambda n: 16 if n % 16 else 1
    cap = cfg.capacity_factor if cfg.n_experts else 1.0
    worst = (cap * 8 / 6 * (m - 6 * vd * tokens) + rep(cfg.vocab_size) * 6 * vd * tokens
             + rep(cfg.n_heads) * a + cross)
    return 0.5 * m / worst, 0.75 * m / (m - 6 * vd * tokens)


@pytest.mark.parametrize("arch,name", COST_CELLS)
def test_run_cost_cell_at_full_width(runs, arch, name):
    port, ref, _ = runs
    rep = port["cost"][f"{arch}|{name}"]
    assert rep["ok"], rep.get("error")
    renamed = {"compile_s": "run_s"}
    assert sorted(rep) == sorted(renamed.get(k, k) for k in ref["cost_keys"])
    assert sorted(rep["roofline"]) == ref["row_keys"]
    assert rep["memory"] == {"per_chip_gb": rep["memory"]["per_chip_gb"], "fits_80gb": None}
    want = jax_roofline.model_flops_for_cell(jax_get_config(arch), JAX_SHAPES[name])
    assert rep["roofline"]["model_gflops"] == want / 1e9
    lo, hi = _useful_band(arch, name)
    assert lo <= rep["roofline"]["useful_frac"] <= hi, (lo, rep["roofline"]["useful_frac"], hi)
    assert rep["layer_pair"] == list(dryrun._layer_pair(get_config(arch)))
    r = rep["roofline"]
    assert r["chips"] == 256 and r["chip_gflops"] > 0 and r["ici_gbytes"] > 0
    assert r["t_compute_ms"] == pytest.approx(r["chip_gflops"] * 1e9 / roofline.PEAK_FLOPS * 1e3)


@pytest.mark.parametrize("arch,name", REDUCED_MOE_CELLS)
def test_reduced_moe_cells(runs, arch, name):
    """The reduced MoE cells on the 16 x 16 mesh (``--reduced``, the scan
    pass): their experts do not divide the model axis, so the capacity MoE
    takes its global route on DTensors; each cell ``ok`` with a finite,
    positive cost."""
    *_, reduced = runs
    rep = reduced[f"{arch}|{name}"]
    assert rep["ok"], rep.get("error")
    assert get_config(arch, reduced=True).n_experts % 16
    r = rep["roofline"]
    assert r["chips"] == 256 and r["chip_gflops"] > 0 and np.isfinite(r["t_memory_ms"])
