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
* the capacity MoE off the expert-parallel route (a batch of 3 rows over a
  data axis of 2, capacity factor 1.0: drops): on x placed over data, y
  and aux bit for bit the plain call's, y placed as x was, both within
  1e-5 of the reference's ``moe_apply`` on the whole batch (one global
  dispatch, as its GSPMD program runs it);
* whole reduced models under the context (qwen3-8b: sp decode; olmoe-1b-7b:
  sp decode and the expert-parallel prefill): prefill logits and greedy
  tokens against the port's own single-process run;
* one FSDP + TP train step (``make_train_step(param_specs=)`` on
  ``DTensor`` s placed by ``param_specs(train=True)``, the batch sharded
  over data) of reduced llama2-7b (plain, ``bf16_gather``, 2 microbatches),
  olmoe-1b-7b (the expert-parallel route under the step) and hymba-1.5b (5
  heads over a model axis of 2), each on the converted reference tree,
  against the reference: the loss within 1e-6 relative and every gathered
  gradient within 2e-5 of its leaf's largest, against
  ``jax.value_and_grad`` of the reference's ``lm_loss`` (its microbatches
  summed and divided as its ``make_train_step`` does); the updated params
  within 2e-5 of a leaf's largest, and the clip's gradient norm within
  1e-6, against the reference's ``adamw_update`` on the mesh's own
  gradients (from a fresh state AdamW's first step is ~lr * sign(g): a
  gradient element near 0 may take either sign, so the update is held on
  the same gradients); gradients, params and moments placed as the specs
  say. olmoe's reference takes 2 microbatches: the expert-parallel route's
  capacity and load-balance loss are per data shard, as the reference's
  are under a distribution context. olmoe-1b-7b with ``n_experts=3`` (not
  divisible by the model axis) takes the global route: its reference is
  one ``value_and_grad`` over the whole batch. The reduced configs compute in
  float32, so ``bf16_gather``'s cast changes no value here;
* a vocab-sharded embedding (llama2-7b with a vocab of 512) and rwkv6-3b's
  WKV scan with 3 heads over the model axis (d_model 48) in the same train
  step, at the same bounds;
* lock-step serving on the mesh (params placed by
  ``param_specs(train=False)``, the cache by ``cache_specs``: batch over
  data, the KV sequence or the state channels over model): a prefill and
  4 greedy ``decode_step`` s of reduced llama2-7b (the cache written on
  each rank's shard), rwkv6-3b (d_model 48: its heads split unevenly) and
  gemma-2b (n_heads 3: one KV head and 3 query heads over 2), every
  rank's logits within 1e-5 of the largest of the reference's unsharded
  lock-step run on the converted tree, and its greedy tokens equal;
* ``launch.train.shard_train_state`` on hymba-1.5b: the seeded init bit
  for bit, placed as the specs say;
* ``launch.train.main`` on every rank with one checkpoint directory (the
  host mesh over the world, no distribution context): 2 steps, then a run
  to step 3 that resumes from step 2; the same losses on every rank, the
  resumed step's loss that of an unbroken single-process run, and the
  directory holds whole steps only (rank 0 writes, every rank waits).
"""
from __future__ import annotations

import functools

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
from repro.models.api import build_model as jax_build_model
from repro.models.api import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.launch import train as train_launcher
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine
from repro_torch.tree import tree_items

SP_CASES = [("full", [256, 256], None), ("ragged", [200, 77], None), ("window", [256, 200], 64)]
TRAFFIC_LENGTHS = [256, 1024]
ATOL_SP = 5e-6
ATOL_MOE = 1e-5
# (label, config, make_train_step options, global batch, the config's
# replace on both sides), each on the converted reference tree. A vocab of
# 512 divides the model axis, so the embedding table is sharded (503
# leaves it whole); d_model 48 gives rwkv6-3b 3 heads over a model axis of
# 2, as rwkv6-3b's 40 heads do not divide 16.
TRAIN_CASES = [("llama2-7b", "llama2-7b", {}, 4, {}),
               ("llama2-7b+bf16_gather", "llama2-7b", {"bf16_gather": True}, 4, {}),
               ("llama2-7b+microbatches=2", "llama2-7b", {"microbatches": 2}, 8, {}),
               ("olmoe-1b-7b", "olmoe-1b-7b", {}, 4, {}),
               ("olmoe-1b-7b+n_experts=3", "olmoe-1b-7b", {}, 4, {"n_experts": 3}),
               ("hymba-1.5b", "hymba-1.5b", {}, 4, {}),
               ("llama2-7b+vocab=512", "llama2-7b", {}, 4, {"vocab_size": 512}),
               ("rwkv6-3b+d_model=48", "rwkv6-3b", {}, 4, {"d_model": 48})]
# (label, config, replace): lock-step serving on placed params and cache.
# gemma-2b's one KV head and (with n_heads 3) its query heads do not
# divide the model axis of 2, as qwen3-8b's 8 KV heads and gemma-2b's 8
# query heads do not divide 16.
DECODE_CASES = [("llama2-7b", "llama2-7b", {}),
                ("rwkv6-3b+d_model=48", "rwkv6-3b", {"d_model": 48}),
                ("gemma-2b+n_heads=3", "gemma-2b", {"n_heads": 3})]
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS, DECODE_MAX_LEN = 4, 8, 4, 32
LOGIT_RTOL = 1e-5
TRAIN_STEP = dict(base_lr=1e-3, warmup=2, total_steps=6)
LOSS_RTOL, GRAD_RTOL, PARAM_RTOL = 1e-6, 2e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_model(name: str, replace: tuple = ()):
    """The reference's reduced ``name`` with ``replace`` (sorted items) and
    its params from PRNGKey(0) as numpy arrays."""
    jm = jax_build_model(jax_get_config(name, reduced=True).replace(**dict(replace)))
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


def _train_inputs() -> list[dict]:
    cases = []
    for label, name, kw, gb, rep in TRAIN_CASES:
        cfg = get_config(name, reduced=True).replace(**rep)
        batch = {k: v.numpy() for k, v in batch_for_step(cfg.vocab_size, 16, gb, 0, 0).items()}
        cases.append({"label": label, "name": name, "step": {**TRAIN_STEP, **kw},
                      "batch": batch, "params": _jax_model(name, tuple(sorted(rep.items())))[1],
                      "replace": rep})
    return cases


def _decode_inputs() -> list[dict]:
    rng = np.random.default_rng(2)
    cases = []
    for label, name, rep in DECODE_CASES:
        jm, params = _jax_model(name, tuple(sorted(rep.items())))
        prompts = rng.integers(0, jm.cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT))
        cases.append({"label": label, "name": name, "replace": rep, "params": params,
                      "prompts": prompts.astype(np.int32), "steps": DECODE_STEPS,
                      "max_len": DECODE_MAX_LEN})
    return cases


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
    # 3 rows over a data axis of 2: the capacity MoE's global route
    moe_global = {"p": stack, "x": f32(3, 16, cfg.d_model), "top_k": cfg.top_k, "cf": 1.0}
    models = {"names": ["qwen3-8b", "olmoe-1b-7b"], "steps": 6,
              "prompts": rng.integers(0, 503, (2, 12)).astype(np.int32)}
    return {"sp": sp, "ctx": ctx, "moe": moe, "moe_global": moe_global, "models": models, "train": _train_inputs(),
            "decode": _decode_inputs(), "shard_train_state": "hymba-1.5b"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, {rank: results}) of one spawned world."""
    inputs = _inputs()
    inputs["ckpt_dir"] = str(tmp_path_factory.mktemp("ckpt"))
    spawn = mp.get_context("spawn")
    queue = spawn.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [spawn.Process(target=world.run, args=(r, store, inputs, queue))
             for r in range(world.WORLD)]
    for p in procs:
        p.start()
    try:
        # the reference's side of every case, while the world runs
        for case in inputs["train"]:
            _reference_step(case)
        for case in inputs["decode"]:
            _reference_decode(case["label"], case["prompts"].tobytes())
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


def test_global_moe_on_a_dtensor(run):
    """The capacity MoE with the batch (3 rows) not dividing the data axis:
    the global route, one dispatch over all 48 tokens with their capacity.
    On x placed over data, y (gathered) and aux are the plain call's bit
    for bit, y placed as x was; both within 1e-5 of the reference's
    ``moe_apply`` on the whole batch, whose capacity 1.0 drops pairs."""
    inputs, results = run
    case = inputs["moe_global"]
    p = {k: jnp.asarray(v) for k, v in case["p"].items()}
    want_y, want_aux = jax.jit(lambda p, x: jax_moe.moe_apply(
        p, x, top_k=case["top_k"], capacity_factor=case["cf"]))(p, jnp.asarray(case["x"]))
    dense = np.asarray(jax_moe.moe_apply_dense_ref(p, jnp.asarray(case["x"]),
                                                   top_k=case["top_k"]))
    assert np.abs(dense - np.asarray(want_y)).max() > 1e-3
    for rank, res in results.items():
        got = _case(res, "moe_global")
        y, aux = got["plain"]
        np.testing.assert_allclose(y, np.asarray(want_y), atol=ATOL_MOE, rtol=0,
                                   err_msg=f"rank {rank}")
        assert aux == pytest.approx(float(want_aux), rel=1e-6), rank
        yd, auxd = got["dtensor"]
        np.testing.assert_array_equal(yd, y, err_msg=f"rank {rank}")
        assert auxd == aux, rank
        assert got["placed"][0] == got["placed"][1] == "(Shard(dim=0), Replicate())", rank


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


def _case(res: dict, key: str) -> dict:
    """One case's results on one rank; the traceback fails the test when
    the case raised there."""
    if isinstance(res[key], str):
        pytest.fail(f"{key} raised on the mesh:\n{res[key]}")
    return res[key]


def _close(got: np.ndarray, want: np.ndarray, rtol: float, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.2e} of the leaf's largest"


@functools.lru_cache(maxsize=None)
def _value_and_grad(name: str, replace: tuple = ()):
    """The reference's jitted ``value_and_grad`` of ``lm_loss`` (no remat)
    on reduced ``name`` with ``replace``."""
    jm = _jax_model(name, replace)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(jm, p, b["tokens"], b["labels"], remat=False)))


_adamw_update = jax.jit(lambda p, g, s, lr: jax_adamw.adamw_update(p, g, s, lr=lr))


_REFERENCE_STEPS: dict = {}


def _reference_step(case: dict) -> tuple[float, dict]:
    """The reference's loss and gradients for ``case``: its jitted
    ``value_and_grad`` of ``lm_loss`` on each microbatch, the gradients
    summed in float32 and both divided by the count, as its
    ``make_train_step`` accumulates them."""
    if case["label"] in _REFERENCE_STEPS:
        return _REFERENCE_STEPS[case["label"]]
    n = case["step"].get("microbatches", 1)
    experts = get_config(case["name"], reduced=True).replace(**case["replace"]).n_experts
    if experts and experts % 2 == 0:
        n = 2                          # expert-parallel: capacity and loss per data shard
    vg = _value_and_grad(case["name"], tuple(sorted(case["replace"].items())))
    loss, grads = 0.0, None
    for part in range(n):
        one = {k: jnp.asarray(np.split(v, n)[part]) for k, v in case["batch"].items()}
        l, g = vg(case["params"], one)
        loss = loss + l
        grads = g if grads is None else jax.tree.map(lambda a, b: a + b, grads, g)
    _REFERENCE_STEPS[case["label"]] = (float(loss / n), dict(tree_items(
        jax.tree.map(lambda g: np.asarray(g / n), grads))))
    return _REFERENCE_STEPS[case["label"]]


@pytest.mark.parametrize("label", [c[0] for c in TRAIN_CASES])
def test_sharded_train_step(run, label):
    inputs, results = run
    case = next(c for c in inputs["train"] if c["label"] == label)
    got = _case(results[0], f"train/{label}")
    want_loss, want_grads = _reference_step(case)
    assert got["loss"] == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert set(got["grads"]) == set(want_grads)
    for path, g in want_grads.items():
        _close(got["grads"][path], g, GRAD_RTOL, f"gradient {path}")
    step = case["step"]
    state = jax_adamw.adamw_init(case["params"])
    lr = jax_adamw.cosine_schedule(state.step, base_lr=step["base_lr"], warmup=step["warmup"],
                                   total=step["total_steps"])
    mesh_grads = tree_map_paths(case["params"], lambda path, _: got["grads"][path])
    want, _, metrics = _adamw_update(case["params"], mesh_grads, state, lr)
    for path, p in tree_items(jax.tree.map(np.asarray, want)):
        _close(got["params"][path], p, PARAM_RTOL, f"updated {path}")
    assert got["metrics"]["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-6)
    assert got["metrics"]["lr"] == pytest.approx(float(lr), rel=1e-6)
    for rank, res in results.items():
        r = _case(res, f"train/{label}")
        assert (r["loss"], r["metrics"]) == (got["loss"], got["metrics"]), rank
        for what in ("grads", "params", "mu", "nu"):
            assert r["placed"][what] == r["specs"], (rank, what)
    assert any("Shard" in pl for pl in got["specs"].values())


@functools.lru_cache(maxsize=None)
def _reference_decode(label: str, prompts_key: bytes) -> tuple[list, list]:
    """The reference's unsharded lock-step run of a decode case: its jitted
    prefill and ``decode_step`` s, greedy on its own logits: (the logits of
    the prefill and of each step, the tokens fed)."""
    _, name, rep = next(c for c in DECODE_CASES if c[0] == label)
    jm, params = _jax_model(name, tuple(sorted(rep.items())))
    prompts = np.frombuffer(prompts_key, np.int32).reshape(DECODE_BATCH, DECODE_PROMPT)
    lg, cache = jax.jit(jm.prefill)(params, jnp.asarray(prompts),
                                    jm.init_cache(DECODE_BATCH, DECODE_MAX_LEN))
    decode = jax.jit(jm.decode_step)
    logits, tokens = [np.asarray(lg)], []
    for _ in range(DECODE_STEPS):
        tokens.append(logits[-1].argmax(-1).astype(np.int32))
        lg, cache = decode(params, jnp.asarray(tokens[-1]), cache)
        logits.append(np.asarray(lg))
    return logits, tokens


@pytest.mark.parametrize("label", [c[0] for c in DECODE_CASES])
def test_sharded_decode(run, label):
    """Prefill and greedy ``decode_step`` s on params placed by
    ``param_specs(train=False)`` and a cache placed by
    ``fixup_tree(cache_specs(...))``: every rank's logits within 1e-5 of
    the largest of the reference's unsharded lock-step run on the same
    tree, its tokens equal, and the cache still placed by its specs (some
    leaf sharded over both axes)."""
    inputs, results = run
    case = next(c for c in inputs["decode"] if c["label"] == label)
    want_logits, want_tokens = _reference_decode(label, case["prompts"].tobytes())
    for rank, res in results.items():
        got = _case(res, f"decode/{label}")
        for step, (g, w) in enumerate(zip(got["logits"], want_logits)):
            _close(g, w, LOGIT_RTOL, f"rank {rank} step {step} logits")
        for g, w in zip(got["tokens"], want_tokens):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank}")
        assert len(got["tokens"]) == DECODE_STEPS
        assert any(pl.count("Shard") == 2 for pl in got["placed"].values()), (rank, got)


def test_shard_train_state(run):
    """The seeded params and AdamW state on the mesh: every leaf placed as
    its spec says (some sharded over both axes), the params the seeded
    init bit for bit, the step 0."""
    _, results = run
    for rank, res in results.items():
        s = res["shard_train_state"]
        for what in ("params", "mu", "nu"):
            assert s["placed"][what] == s["specs"], (rank, what)
        assert s["step"] == 0, rank
    assert results[0]["shard_train_state"]["seeded"]
    assert any(pl.count("Shard") == 2 for pl in results[0]["shard_train_state"]["specs"].values())


def test_launcher_checkpoints_across_ranks(run, tmp_path):
    """``launch.train.main`` on the 4 ranks, one checkpoint directory: the
    same losses on every rank; the second run resumes at step 2 with the
    loss of an unbroken single-process run; the directory holds steps 1-3
    and no partial step."""
    _, results = run
    mine = results[0]["launcher"]
    assert [s for s, _ in mine["first"]] == [0, 1] and [s for s, _ in mine["second"]] == [2]
    for rank, res in results.items():
        assert res["launcher"]["first"] == mine["first"], rank
        assert res["launcher"]["second"] == mine["second"], rank
    assert mine["files"] == [f"step_{s:010d}" for s in (1, 2, 3)]
    whole = train_launcher.main(["--arch", "llama2-7b", "--reduced", "--device", "cpu",
                                 "--seq-len", "16", "--global-batch", "4", "--steps", "3",
                                 "--ckpt-dir", str(tmp_path)])
    want = [(h["step"], h["loss"]) for h in whole]
    assert [s for s, _ in want] == [0, 1, 2]
    for (s, got), (_, w) in zip(mine["first"] + mine["second"], want):
        assert got == pytest.approx(w, rel=1e-6), s


def tree_map_paths(tree: dict, fn, prefix: str = "") -> dict:
    """``fn(path, leaf)`` over a tree, keeping its structure."""
    return {k: tree_map_paths(v, fn, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(prefix + k, v) for k, v in tree.items()}
