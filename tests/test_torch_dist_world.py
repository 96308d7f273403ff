"""The distribution layer across processes: one 4-rank gloo world (mesh
data 2 x model 2, ``tests/_torch_dist_world.py``), spawned once for the
module, runs every multi-rank case; the results come back as numpy arrays
and are held here against the reference computed on one JAX CPU device:

* ``decode_attention_sp`` on the cases of
  ``tests/test_distributed.py::test_sequence_parallel_decode_multidevice``
  (full, ragged with one shard all masked, window) against
  ``swiftkv_decode_ref``, 5e-6;
* ``decode_attention(impl="sp")`` under ``set_context`` with the batch
  sharded over data (``tests/test_perf_features.py``'s case) against the
  reference's ``impl="naive"``, 5e-6, at S 256 and 1024; the bytes each
  rank sends in the state all-gather are ``B_loc * Hq * (D + 2) * 4`` at
  both lengths;
* the expert-parallel MoE on olmoe-1b-7b's reduced expert stack, gated and
  not, at the config's capacity factor and at 1.0 (drops), x replicated and
  x a DTensor over data: y within 1e-5 and aux of the reference's
  ``moe_apply`` on each data shard's rows (the EP capacity), one all-reduce
  a call;
* whole reduced models under the context (qwen3-8b: sp decode; olmoe-1b-7b:
  sp decode and the expert-parallel prefill): prefill logits and greedy
  tokens against the port's own single-process run."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_world as world
from repro.configs import get_config as jax_get_config
from repro.core import attention as jax_attn
from repro.kernels.swiftkv_decode.ref import swiftkv_decode_ref
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine

SP_CASES = [("full", [256, 256], None), ("ragged", [200, 77], None), ("window", [256, 200], 64)]
TRAFFIC_LENGTHS = [256, 1024]
ATOL_SP = 5e-6
ATOL_MOE = 1e-5


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    sp = {"q": f32(2, 4, 32), "k": f32(2, 256, 2, 32), "v": f32(2, 256, 2, 32),
          "cases": SP_CASES}
    ctx = {"q": f32(4, 4, 32), "k": f32(4, 1024, 2, 32), "v": f32(4, 1024, 2, 32),
           "lengths": np.array([256, 100, 17, 200], np.int32),
           "traffic_lengths": TRAFFIC_LENGTHS}
    cfg = jax_get_config("olmoe-1b-7b", reduced=True)
    stack = jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.PRNGKey(0), cfg.d_model,
                                                       cfg.d_ff, cfg.n_experts))
    x = f32(4, 32, cfg.d_model)              # 64 tokens a data shard: cf 1.0 drops
    moe = {}
    for gated in (True, False):
        for cf in (cfg.capacity_factor, 1.0):
            p = stack if gated else {k: v for k, v in stack.items() if k != "gate"}
            moe[f"gated={gated},cf={cf}"] = {"p": p, "x": x, "top_k": cfg.top_k, "cf": cf}
    models = {"names": ["qwen3-8b", "olmoe-1b-7b"], "steps": 6,
              "prompts": rng.integers(0, 503, (2, 12)).astype(np.int32)}
    return {"sp": sp, "ctx": ctx, "moe": moe, "models": models}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, {rank: results}) of one spawned world."""
    inputs = _inputs()
    spawn = mp.get_context("spawn")
    queue = spawn.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [spawn.Process(target=world.run, args=(r, store, inputs, queue))
             for r in range(world.WORLD)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    for rank, res in results.items():
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return inputs, results


def test_world_layout(run):
    """Rank r sits at (data r // 2, model r % 2), as ``jax.make_mesh`` lays a
    (2, 2) mesh over four devices."""
    _, results = run
    assert {r: res["coord"] for r, res in results.items()} == \
        {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1)}


@pytest.mark.parametrize("case", [c[0] for c in SP_CASES])
def test_sequence_parallel_decode(run, case):
    inputs, results = run
    sp = inputs["sp"]
    _, lens, win = next(c for c in SP_CASES if c[0] == case)
    want = np.asarray(swiftkv_decode_ref(jnp.asarray(sp["q"]), jnp.asarray(sp["k"]),
                                         jnp.asarray(sp["v"]), jnp.asarray(lens, jnp.int32),
                                         window=win))
    if case == "ragged":                 # row 1's second shard (128..255) is all masked
        assert lens[1] <= 128
    for rank, res in results.items():
        got = res[f"sp/{case}"]
        assert np.isfinite(got).all(), rank
        np.testing.assert_allclose(got, want, atol=ATOL_SP, rtol=0, err_msg=f"rank {rank}")


@pytest.mark.parametrize("s_len", TRAFFIC_LENGTHS)
def test_sp_through_context_batch_sharded(run, s_len):
    inputs, results = run
    c = inputs["ctx"]
    lengths = np.minimum(c["lengths"], s_len)
    want = np.asarray(jax_attn.decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"][:, :s_len]), jnp.asarray(c["v"][:, :s_len]),
        jnp.asarray(lengths), impl="naive"))
    for rank, res in results.items():
        row = res["coord"][0] * 2                     # this rank's rows: 2 of 4
        np.testing.assert_allclose(res[f"ctx/{s_len}"], want[row:row + 2], atol=ATOL_SP,
                                   rtol=0, err_msg=f"rank {rank}")


def test_sp_traffic_does_not_grow_with_the_context(run):
    """Each rank sends its rows' (mu, Z, Y): B_loc * Hq * (D + 2) float32
    values, at S 256 and at S 1024 alike."""
    inputs, results = run
    b, hq, d = inputs["ctx"]["q"].shape
    want = (b // 2) * hq * (d + 2) * 4
    for rank, res in results.items():
        assert [res[f"ctx/{s}/bytes"] for s in TRAFFIC_LENGTHS] == [want, want], rank


@pytest.mark.parametrize("name", ["gated=True,cf=8.0", "gated=True,cf=1.0",
                                  "gated=False,cf=8.0", "gated=False,cf=1.0"])
def test_expert_parallel_moe(run, name):
    inputs, results = run
    case = inputs["moe"][name]
    p = {k: jnp.asarray(v) for k, v in case["p"].items()}
    kw = dict(top_k=case["top_k"], gated="gate" in p, capacity_factor=case["cf"])
    apply = jax.jit(lambda p, x: jax_moe.moe_apply(p, x, **kw))
    shards = [apply(p, jnp.asarray(case["x"][i:i + 2])) for i in (0, 2)]
    want_y = np.concatenate([np.asarray(y) for y, _ in shards])
    want_aux = (float(shards[0][1]) + float(shards[1][1])) / 2
    if case["cf"] == 1.0:             # the capacity bites: some pairs drop
        dense = np.asarray(jax_moe.moe_apply_dense_ref(p, jnp.asarray(case["x"]),
                                                       top_k=case["top_k"], gated="gate" in p))
        assert np.abs(dense - want_y).max() > 1e-3
    for rank, res in results.items():
        y, aux = res[f"moe/{name}/plain"]
        np.testing.assert_allclose(y, want_y, atol=ATOL_MOE, rtol=0, err_msg=f"rank {rank}")
        assert aux == pytest.approx(want_aux, rel=1e-6), rank
        row = res["coord"][0] * 2
        yd, auxd = res[f"moe/{name}/dtensor"]
        np.testing.assert_allclose(yd, want_y[row:row + 2], atol=ATOL_MOE, rtol=0,
                                   err_msg=f"rank {rank}")
        assert auxd == aux, rank
        assert res[f"moe/{name}/all_reduces"] == 2, rank        # one a call


@pytest.mark.parametrize("name", ["qwen3-8b", "olmoe-1b-7b"])
def test_models_under_the_context(run, name):
    """A reduced model with ``decode_impl="sp"`` under the (2, 2) context on
    every rank: its prefill logits within 1e-5 and its greedy tokens equal
    to the single-process blockwise run; one state all-gather a layer and
    decode step (the generate's 6 steps and the warm prefill's none), and
    on olmoe one expert-parallel all-reduce a MoE layer and prefill."""
    inputs, results = run
    m = inputs["models"]
    model = build_model(get_config(name, reduced=True), device="cpu")
    params = model.init_params(0)
    prompts = torch.from_numpy(m["prompts"])
    with torch.inference_mode():
        logits, _ = model.prefill(params, prompts, model.init_cache(*prompts.shape))
        toks = ServingEngine(model, params, max_len=32, batch=prompts.shape[0]).generate(
            prompts, steps=m["steps"])
    cfg = model.cfg
    for rank, res in results.items():
        got_logits, got_toks, coll = res[f"model/{name}"]
        np.testing.assert_allclose(got_logits, logits.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got_toks, toks.numpy(), err_msg=f"rank {rank}")
        assert coll["sp_all_gather"] == cfg.n_layers * m["steps"], (rank, coll)
        assert coll["ep_all_reduce"] == (2 * cfg.n_layers if cfg.n_experts else 0), (rank, coll)
