"""The body of one rank of the 4-process gloo world of
``tests/test_torch_dist_world.py``: a (data 2, model 2) mesh, every
multi-rank case run once, the results sent back as numpy arrays. It
imports neither jax nor the reference, so each spawned process pays only
torch's import."""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def _dtensor(full: np.ndarray, mesh, spec: tuple):
    """The DTensor of ``full`` placed by ``spec`` (one entry per dim: an
    axis name or None), from this rank's local slice."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.context import get_context
    from repro_torch.distributed.sharding import placements
    ctx, x = get_context(), torch.from_numpy(full)
    for dim, axis in enumerate(spec):
        if axis is not None:
            n, i = ctx.axis_size(axis), ctx.axis_index(axis)
            step = x.shape[dim] // n
            x = x.narrow(dim, i * step, step)
    return DTensor.from_local(x.contiguous(), mesh, placements(spec, mesh), run_check=False)


def _cases(mesh, inputs: dict) -> dict:
    from repro_torch.core import attention as attn
    from repro_torch.distributed.context import (COLLECTIVES, clear_context, get_context,
                                                 set_context)
    from repro_torch.distributed.sp_attention import decode_attention_sp
    from repro_torch.models import moe
    out: dict = {}
    t = lambda a: torch.from_numpy(a)
    # decode_attention_sp on plain (replicated) tensors, no context
    q, k, v = (t(inputs["sp"][n]) for n in ("q", "k", "v"))
    for name, lens, win in inputs["sp"]["cases"]:
        got = decode_attention_sp(q, k, v, torch.tensor(lens, dtype=torch.int32), mesh=mesh,
                                  seq_axes="model", window=win)
        out[f"sp/{name}"] = got.numpy()
    ctx = set_context(mesh, batch_axes=("data",), model_axis="model")
    out["coord"] = (ctx.axis_index("data"), ctx.axis_index("model"))
    # decode_attention(impl="sp") through the context, the batch sharded over data
    c = inputs["ctx"]
    for s_len in c["traffic_lengths"]:
        args = [_dtensor(c["q"], mesh, ("data", None, None)),
                _dtensor(c["k"][:, :s_len], mesh, ("data", "model", None, None)),
                _dtensor(c["v"][:, :s_len], mesh, ("data", "model", None, None)),
                _dtensor(np.minimum(c["lengths"], s_len), mesh, ("data",))]
        before = COLLECTIVES["sp_all_gather_bytes"]
        got = attn.decode_attention(*args, impl="sp")
        out[f"ctx/{s_len}"] = got.to_local().numpy()
        out[f"ctx/{s_len}/bytes"] = COLLECTIVES["sp_all_gather_bytes"] - before
    # the expert-parallel MoE: x plain (replicated) and x a DTensor over data
    for name, case in inputs["moe"].items():
        p = {k: t(v) for k, v in case["p"].items()}
        kw = dict(top_k=case["top_k"], gated="gate" in p, capacity_factor=case["cf"])
        before = COLLECTIVES["ep_all_reduce"]
        y, aux = moe.moe_apply(p, t(case["x"]), **kw)
        out[f"moe/{name}/plain"] = (y.numpy(), float(aux))
        yd, auxd = moe.moe_apply(p, _dtensor(case["x"], mesh, ("data", None, None)), **kw)
        out[f"moe/{name}/dtensor"] = (yd.to_local().numpy(), float(auxd))
        out[f"moe/{name}/all_reduces"] = COLLECTIVES["ep_all_reduce"] - before
    out["moe_global"] = _guarded(_moe_global, mesh, inputs["moe_global"])
    # whole models under the context: qwen3-8b (sp decode) and olmoe-1b-7b (sp
    # decode, the expert-parallel prefill), weights replicated, the batch whole
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import ServingEngine
    for name in inputs["models"]["names"]:
        model = build_model(get_config(name, reduced=True).replace(decode_impl="sp"),
                            device="cpu")
        params = model.init_params(0)
        prompts = t(inputs["models"]["prompts"])
        before = dict(COLLECTIVES)
        with torch.inference_mode():
            logits, _ = model.prefill(params, prompts, model.init_cache(*prompts.shape))
            toks = ServingEngine(model, params, max_len=32, batch=prompts.shape[0]).generate(
                prompts, steps=inputs["models"]["steps"])
        out[f"model/{name}"] = (logits.numpy(), toks.numpy(),
                                {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES})
    out.update(_train_cases(mesh, inputs["train"]))
    out.update(_decode_cases(mesh, inputs["decode"]))
    out["shard_train_state"] = _shard_train_state(mesh, inputs["shard_train_state"])
    clear_context()                  # the launcher installs none
    out["launcher"] = _launcher(inputs["ckpt_dir"])
    assert not get_context().active
    return out


def _moe_global(mesh, case: dict) -> dict:
    """The capacity MoE off the expert-parallel route (a batch that does
    not divide the data axis): the plain call, and the call on x placed
    unevenly over data (``Shard`` cuts 3 rows as 2 and 1), gathered."""
    from repro_torch.distributed.sharding import device_put, replicated_value
    from repro_torch.models import moe
    p = {k: torch.from_numpy(v) for k, v in case["p"].items()}
    kw = dict(top_k=case["top_k"], gated="gate" in p, capacity_factor=case["cf"])
    x = torch.from_numpy(case["x"])
    y, aux = moe.moe_apply(p, x, **kw)
    xd = device_put({"x": x}, {"x": ("data", None, None)}, mesh)["x"]
    yd, auxd = moe.moe_apply(p, xd, **kw)
    return {"plain": (y.numpy(), float(aux)),
            "dtensor": (yd.full_tensor().numpy(), float(replicated_value(auxd))),
            "placed": (str(tuple(xd.placements)), str(tuple(yd.placements)))}


def _train_cases(mesh, cases: list[dict]) -> dict:
    """One sharded train step a case: the converted reference tree placed
    by ``param_specs(train=True)``, the batch sharded over data,
    ``make_train_step(param_specs=)``'s loss and gradients, then the step
    itself. Rank 0 sends the gathered arrays; every rank its loss, metrics
    and the placements of params, gradients and moments."""
    return {f"train/{case['label']}": _guarded(_train_case, mesh, case) for case in cases}


def _guarded(fn, *args):
    """``fn(*args)``, or the traceback of its failure: one case's fault
    fails its own test, not the world (every rank runs the same code, so
    every rank fails alike, before the same collective)."""
    try:
        return fn(*args)
    except Exception:
        return traceback.format_exc()


def _train_case(mesh, case: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax
    from repro_torch.distributed import sharding
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    cfg = get_config(case["name"], reduced=True).replace(**case["replace"])
    model = build_model(cfg, device="cpu")
    params = from_jax(case["params"], "cpu")
    specs = sharding.fixup_tree(sharding.param_specs(
        params, sharding.MeshRules(mesh), train=True), params, mesh)
    params = sharding.device_put(params, specs, mesh)
    opt = adamw_init(params)
    batch = sharding.device_put({k: torch.from_numpy(v) for k, v in case["batch"].items()},
                                {k: ("data", None) for k in case["batch"]}, mesh)
    step = make_train_step(model, param_specs=specs, **case["step"])
    loss, grads = step.loss_and_grads(params, batch)
    res = {"loss": float(sharding.replicated_value(loss)),
           "specs": _specs(specs, mesh), "placed": {"grads": _placed(grads)}}
    gathered = {"grads": _full(grads)}               # collectives: every rank joins
    params, opt, metrics = step(params, opt, batch)
    gathered["params"] = _full(params)
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    res["placed"].update(params=_placed(params), mu=_placed(opt.mu), nu=_placed(opt.nu))
    if dist.get_rank() == 0:
        res.update(gathered)
    return res


def _decode_cases(mesh, cases: list[dict]) -> dict:
    """Lock-step serving on the mesh, a case each: the converted reference
    tree placed by ``param_specs(train=False)``, the cache by
    ``fixup_tree(cache_specs(...))`` (batch over data, the KV sequence or
    the state channels over model), then a prefill and greedy
    ``decode_step`` s under ``implicit_replication``. Every rank sends the
    gathered logits of the prefill and each step, the tokens fed, and the
    cache's placements after the last step."""
    return {f"decode/{case['label']}": _guarded(_decode_case, mesh, case) for case in cases}


def _decode_case(mesh, case: dict) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax
    from repro_torch.distributed import sharding
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeSpec
    rules = sharding.MeshRules(mesh)
    cfg = get_config(case["name"], reduced=True).replace(**case["replace"])
    model = build_model(cfg, device="cpu")
    params = from_jax(case["params"], "cpu")
    params = sharding.device_put(params, sharding.fixup_tree(
        sharding.param_specs(params, rules, train=False), params, mesh), mesh)
    prompts = torch.from_numpy(case["prompts"])
    b = prompts.shape[0]
    cache = model.init_cache(b, case["max_len"])
    shape = ShapeSpec("decode", case["max_len"], b, "decode")
    cache = sharding.device_put(cache, sharding.fixup_tree(
        sharding.cache_specs(cfg, shape, rules), cache, mesh), mesh)
    logits, tokens = [], []
    with torch.no_grad(), implicit_replication():
        lg, cache = model.prefill(params, prompts, cache)
        for _ in range(case["steps"]):
            logits.append(sharding.replicated_value(lg).numpy())
            tok = torch.from_numpy(logits[-1].argmax(-1).astype(np.int32))
            tokens.append(tok.numpy())
            lg, cache = model.decode_step(params, tok, cache)
        logits.append(sharding.replicated_value(lg).numpy())
    return {"logits": logits, "tokens": tokens,
            "placed": {k: str(tuple(v.placements)) for k, v in cache.items()
                       if sharding.is_dtensor(v)}}


def _placed(tree: dict) -> dict:
    from repro_torch.tree import tree_items
    return {k: str(tuple(v.placements)) for k, v in tree_items(tree)}


def _full(tree: dict) -> dict:
    from repro_torch.tree import tree_items
    return {k: v.full_tensor().numpy() for k, v in tree_items(tree)}


def _specs(specs: dict, mesh) -> dict:
    from repro_torch.distributed.sharding import named
    from repro_torch.tree import tree_items
    return {k: str(tuple(pl)) for k, pl in tree_items(named(specs, mesh))}


def _shard_train_state(mesh, name: str) -> dict:
    """``launch.train.shard_train_state`` on reduced ``name``: the
    placements of params and moments beside their specs', and (rank 0)
    whether the gathered params are the seeded init bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import shard_train_state
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_items
    model = build_model(get_config(name, reduced=True), device="cpu")
    params, opt, specs = shard_train_state(model, mesh, seed=0)
    full = _full(params)
    want = dict(tree_items(model.init_params(0)))
    return {"specs": _specs(specs, mesh),
            "placed": {"params": _placed(params), "mu": _placed(opt.mu), "nu": _placed(opt.nu)},
            "step": int(opt.step),
            "seeded": all(np.array_equal(v, want[k].numpy()) for k, v in full.items())}


def _launcher(ckpt_dir: str) -> dict:
    """``launch.train.main`` on every rank of the world (the host mesh over
    it, one checkpoint directory for all): 2 steps saved at each, then a
    second run to step 3 that resumes from step 2. Each rank's losses, and
    the directory as rank 0 sees it after both runs."""
    from repro_torch.launch import train
    args = ["--arch", "llama2-7b", "--reduced", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "4", "--ckpt-dir", ckpt_dir, "--ckpt-every", "1"]
    first = train.main(args + ["--steps", "2"])
    second = train.main(args + ["--steps", "3"])
    return {"first": [(h["step"], h["loss"]) for h in first],
            "second": [(h["step"], h["loss"]) for h in second],
            "files": sorted(os.listdir(ckpt_dir))}


def run(rank: int, store_path: str, inputs: dict, queue) -> None:
    """One rank: join the world (its rendezvous a file store at
    ``store_path``: no port to find, no host name to look up), run every
    case, send ``(rank, results)`` (or ``(rank, the traceback)``) back,
    leave the world."""
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    from repro_torch.distributed.context import clear_context
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_host_mesh(model_parallel=2, device_type="cpu")
        queue.put((rank, _cases(mesh, inputs)))
    except Exception:
        queue.put((rank, traceback.format_exc()))
    finally:
        clear_context()
        dist.destroy_process_group()
