"""The distribution layer's one-process parts against the reference: the
shape cells (``ShapeSpec``, ``SHAPES``, ``shape_applicable``),
``input_specs``, the sharding rules (``param_specs`` for training and
serving, ``batch_specs``, ``cache_specs``, ``fixup_divisibility``) on fake
meshes of 16 x 16 and 2 x 16 x 16 for all 12 configs at full size,
``make_production_mesh`` on torch's in-process ``fake`` backend (in a
subprocess, so no process group is left in the test process),
``swiftkv_decode_sharded_reference``, and ``decode_impl="sp"`` without a
distribution context (the blockwise fallback) lock-step and continuous."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_parity import check_engine, pair
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.core import swiftkv as jax_swiftkv
from repro.distributed import sharding as jax_sharding
from repro.models.api import build_model as jax_build_model
from repro.models.api import input_specs as jax_input_specs
from repro.models.quantized import quantize_params as jax_quantize_params
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.core import swiftkv
from repro_torch.distributed import sharding
from repro_torch.models.api import input_specs
from repro_torch.serving import ServingEngine
from repro_torch.tree import tree_items

ROOT = Path(__file__).resolve().parent.parent


class _FakeMesh:
    """A mesh as the rules read it: axis names and sizes."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def test_shape_cells_equal_the_reference():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name]), (arch, name)


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    """Every applicable cell at full size: each input's shape and dtype
    equal the reference's ``jax.eval_shape`` tree, leaf for leaf."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        want = _jax_leaves(jax_input_specs(jcfg, JAX_SHAPES[name]))
        got = dict(tree_items(input_specs(cfg, shape)))
        assert got.keys() == want.keys(), (arch, name)
        for path, (shp, dt) in got.items():
            assert shp == want[path].shape, (arch, name, path)
            assert str(dt).removeprefix("torch.") == want[path].dtype.name, (arch, name, path)


def _spec(p) -> tuple:
    """A ``PartitionSpec`` as the port writes a spec."""
    return tuple(p)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_batch_and_cache_specs_equal_the_reference(arch, mesh):
    """Spec for spec against the reference's ``PartitionSpec`` trees, the
    params at full size (and their W4A8 twins), with
    ``fixup_divisibility`` dropping what the mesh does not divide."""
    fake = _FakeMesh(MESHES[mesh])
    rules, jrules = sharding.MeshRules(fake), jax_sharding.MeshRules(fake)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(jax_build_model(jcfg).init_params, jax.random.PRNGKey(0))
    for tree in (shapes, jax.eval_shape(jax_quantize_params, shapes)):
        nested = sharding._unflatten({path: tuple(leaf.shape)
                                      for path, leaf in _jax_leaves(tree).items()})
        for train in (True, False):
            want = _jax_leaves(jax_sharding.param_specs(tree, jrules, train=train))
            got = dict(tree_items(sharding.param_specs(nested, rules, train=train)))
            assert got.keys() == want.keys()
            for path, spec in got.items():
                assert spec == _spec(want[path]), (arch, mesh, train, path)
    for name, shape in SHAPES.items():
        want = _jax_leaves(jax_sharding.batch_specs(jcfg, JAX_SHAPES[name], jrules))
        got = dict(tree_items(sharding.batch_specs(cfg, shape, rules)))
        assert got == {k: _spec(v) for k, v in want.items()}, (arch, name)
        if shape.kind == "decode":
            want = jax_sharding.cache_specs(jcfg, JAX_SHAPES[name], jrules)
            assert sharding.cache_specs(cfg, shape, rules) == \
                {k: _spec(v) for k, v in want.items()}
            # and over the cell's own cache shapes, as a launcher would apply them
            cache = input_specs(cfg, shape)["cache"]
            jcache = jax_input_specs(jcfg, JAX_SHAPES[name])["cache"]
            got = sharding.fixup_tree(sharding.cache_specs(cfg, shape, rules), cache, fake)
            want = jax_sharding.fixup_tree(want, jcache, fake)
            assert got == {k: _spec(v) for k, v in want.items()}, (arch, name)


def test_fixup_drops_nondivisible():
    """The cases of ``tests/test_distributed.py::test_fixup_drops_nondivisible``."""
    mesh = _FakeMesh({"data": 16, "model": 16})
    cases = [(("model", None), (503, 64)), (("model", None), (512, 64)),
             ((("data", "model"), None), (256, 8)), ((("data", "model"), None), (128, 8)),
             (("data",), (32, 7, 9))]
    for spec, shape in cases:
        assert sharding.fixup_divisibility(spec, shape, mesh) == \
            _spec(jax_sharding.fixup_divisibility(P(*spec), shape, mesh)), (spec, shape)
    assert sharding.fixup_divisibility(("model", None), (503, 64), mesh) == (None, None)
    assert sharding.fixup_divisibility(("data",), (32, 7, 9), mesh) == ("data", None, None)
    assert sharding.mesh_axis_names(True) == jax_sharding.mesh_axis_names(True)
    assert sharding.mesh_axis_names(False) == jax_sharding.mesh_axis_names(False)


_FAKE_WORLD = r"""
import json, sys
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed.sharding import placements
from repro_torch.launch.mesh import make_host_mesh, make_mesh_for, make_production_mesh
world = int(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=world)
out = {}
try:
    make_production_mesh(multi_pod=world == 256, device_type="cpu")
except ValueError as e:
    out["wrong_world"] = str(e)
m = make_production_mesh(multi_pod=world == 512, device_type="cpu")
out["production"] = [list(m.mesh_dim_names), list(m.shape)]
e = make_mesh_for(256, pods=world // 256, device_type="cpu")
out["elastic"] = [list(e.mesh_dim_names), list(e.shape)]
h = make_host_mesh(device_type="cpu")
out["host"] = [list(h.mesh_dim_names), list(h.shape)]
out["placements"] = [repr(p) for p in placements((None, ("pod", "data"), "model", None), m)
                     ] if world == 512 else [repr(p) for p in placements(("data", None, "model"), m)]
# the launchers' --production-mesh over this world (a reduced model, plain
# params: no collective runs); the 16 x 16 mesh needs 256 ranks
from repro_torch.distributed.context import get_context
from repro_torch.launch import serve, train
args = ["--arch", "llama2-7b", "--reduced", "--device", "cpu", "--production-mesh"]
try:
    hist = train.main(args + ["--steps", "1", "--seq-len", "8", "--global-batch", "2",
                              "--ckpt-dir", sys.argv[2]])
    out["train_steps"] = [h["step"] for h in hist]
    toks, _ = serve.main(args + ["--batch", "2", "--prompt-len", "4", "--gen", "2"])
    out["served"] = list(toks.shape)
except ValueError as e:
    out["launch_error"] = str(e)
out["context_left"] = get_context().active
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.mark.parametrize("world", [256, 512])
def test_production_mesh_on_the_fake_backend(world, tmp_path):
    """Shapes and names of the meshes over a fake world of 256 / 512 ranks;
    a world of the wrong size raises; specs become DTensor placements. The
    launchers' ``--production-mesh`` trains and serves under the 16 x 16
    mesh on the 256-rank world (the mesh entered, no distribution context
    installed, as the reference's launchers install none) and fails on the
    512-rank one."""
    import json
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _FAKE_WORLD, str(world), str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    multi = world == 512
    names = list(jax_sharding.mesh_axis_names(multi))
    assert out["production"] == [names, [2, 16, 16] if multi else [16, 16]]
    assert out["elastic"] == out["production"]
    assert out["host"] == [["data", "model"], [world // 2, 2]]
    assert "needs a world of" in out["wrong_world"]
    if multi:
        assert out["placements"] == ["Shard(dim=1)", "Shard(dim=1)", "Shard(dim=2)"]
        assert "needs a world of 256 ranks" in out["launch_error"]
    else:
        assert out["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
        assert out["train_steps"] == [0] and out["served"] == [2, 2]
        assert "data=16, model=16" in res.stderr          # the train launcher's mesh line
    assert out["context_left"] is False


@pytest.mark.parametrize("lens", [[64, 64, 20], [64, 33, 0], [0, 64, 64]])
def test_sharded_reference_equals_the_reference(lens):
    """The one-process fold-then-merge over three shards, one of them wholly
    past the length in two cases (length 0: Z = 0, no weight, no NaN)."""
    rng = np.random.default_rng(sum(lens))
    q = rng.standard_normal(32).astype(np.float32)
    ks = [rng.standard_normal((64, 32)).astype(np.float32) for _ in lens]
    vs = [rng.standard_normal((64, 32)).astype(np.float32) for _ in lens]
    want = np.asarray(jax_swiftkv.swiftkv_decode_sharded_reference(
        jnp.asarray(q), [jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in vs], lens))
    got = swiftkv.swiftkv_decode_sharded_reference(
        torch.from_numpy(q), [torch.from_numpy(k) for k in ks],
        [torch.from_numpy(v) for v in vs], lens).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the monoid: equal to the dense oracle over the valid rows
    kv = lambda xs: torch.from_numpy(np.concatenate([x[:n] for x, n in zip(xs, lens)]))
    dense = swiftkv.softmax_attention_reference(
        torch.from_numpy(q)[None, None, None], kv(ks)[None, :, None], kv(vs)[None, :, None])
    np.testing.assert_allclose(got, dense[0, 0, 0].numpy(), atol=1e-5, rtol=0)


def test_sp_without_a_context_is_the_reference_fallback():
    """qwen3-8b reduced, ``decode_impl="sp"`` with no distribution context:
    the prefill's and 6 greedy decode steps' logits against the reference's
    ``sp`` fallback (``tests/test_perf_features.py::test_sp_impl_falls_back_without_mesh``),
    and ``generate``'s greedy tokens equal."""
    jm, params, tm, tparams = pair("qwen3-8b", "sp")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0, jm.cfg.vocab_size))
    decode = jax.jit(jm.decode_step)
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks), jm.init_cache(2, 128, None))
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, torch.from_numpy(toks.copy()), tm.init_cache(2, 128))
        for step in range(7):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, err_msg=str(step))
            tok = jnp.argmax(jl, -1).astype(jnp.int32)
            jl, jc = decode(params, tok, jc)
            tl, tc = tm.decode_step(tparams, torch.from_numpy(np.asarray(tok)), tc)
    want = JaxServingEngine(jm, params, max_len=64, batch=2).generate(jnp.asarray(toks[:, :12]),
                                                                      steps=10)
    got = ServingEngine(tm, tparams, max_len=64, batch=2).generate(
        torch.from_numpy(toks[:, :12]), steps=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ticks", [1, 8])
def test_sp_without_a_context_continuous_tokens(ticks):
    """The continuous engine on ``decode_impl="sp"`` with no context: greedy
    tokens equal the reference engine's on ``sp``."""
    check_engine("qwen3-8b", ticks, decode_impl="sp")


def test_serve_cli_takes_sp(capsys):
    """``serve --decode-impl sp`` runs; the launcher sets no context (as the
    reference's builds a mesh but sets none), so it serves blockwise."""
    import json
    from repro_torch.distributed.context import get_context
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--decode-impl", "sp",
                "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["decode_impl"] == "sp" and out["generated"] == 4
    assert not get_context().active
