"""Mesh construction. Port of ``repro.launch.mesh``.

Functions, not module constants: importing this module touches no process
group. Each builds a ``DeviceMesh`` over the initialized
``torch.distributed`` world (``init_process_group`` first, with its
address, world size and rank given: nothing here discovers a cluster;
:func:`init_world` joins the one ``torchrun`` describes in the
environment, as the launchers do).

Axes:
  * ``pod``   — data parallel across pods (gradient all-reduce).
  * ``data``  — in-pod data parallel + the FSDP axis.
  * ``model`` — the tensor / expert / sequence parallel axis (heads and
                FFN columns spread across it; the decode cache's sequence).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_world(device_type: str) -> bool:
    """Whether a ``torch.distributed`` world is up: the one already
    initialized, or the one ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), joined
    here with ``init_method="env://"`` (NCCL for ``cuda``, each rank on the
    GPU ``LOCAL_RANK`` names; gloo otherwise). Without either, False: a
    single process with no mesh."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://")
    return True


def launcher_mesh(production: bool, device_type: str) -> DeviceMesh | None:
    """The launchers' mesh: with ``production`` the 16 x 16 production mesh
    (a world of 256 ranks, from :func:`init_world`; without one it raises
    and says so), else the host mesh over the world, or None for a single
    process outside any world."""
    world = init_world(device_type)
    if production:
        if not world:
            raise RuntimeError(
                "--production-mesh: the (data 16, model 16) mesh needs a torch.distributed "
                "world of 256 ranks (512 with multi_pod) and none is initialized; launch "
                "under torchrun, e.g. torchrun --nnodes 32 --nproc-per-node 8 ...")
        return make_production_mesh(device_type=device_type)
    return make_host_mesh(device_type=device_type) if world else None


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs a world of {n} ranks, "
                         f"this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh_for(devices_per_pod: int, pods: int = 1, model_parallel: int = 16, *,
                  device_type: str = "cuda") -> DeviceMesh:
    """Elastic variant: a (pods, dp, tp) mesh from whatever ranks survive a
    failure; the launcher calls it again with the new counts."""
    dp = devices_per_pod // model_parallel
    if pods > 1:
        return _mesh((pods, dp, model_parallel), ("pod", "data", "model"), device_type)
    return _mesh((dp, model_parallel), ("data", "model"), device_type)


def make_host_mesh(model_parallel: int | None = None, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over every rank of the world (tests, one card:
    a world of one rank gives the (1, 1) mesh)."""
    n = dist.get_world_size()
    tp = model_parallel or (2 if n % 2 == 0 and n > 1 else 1)
    return _mesh((n // tp, tp), ("data", "model"), device_type)
