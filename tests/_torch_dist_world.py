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
    from repro_torch.distributed.context import COLLECTIVES, get_context, set_context
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
    assert get_context().active
    return out


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
