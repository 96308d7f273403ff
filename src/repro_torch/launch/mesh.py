"""Mesh construction. Port of ``repro.launch.mesh``.

Functions, not module constants: importing this module touches no process
group. Each builds a ``DeviceMesh`` over the initialized
``torch.distributed`` world (``init_process_group`` first, with its
address, world size and rank given: nothing here discovers a cluster).

Axes:
  * ``pod``   — data parallel across pods (gradient all-reduce).
  * ``data``  — in-pod data parallel + the FSDP axis.
  * ``model`` — the tensor / expert / sequence parallel axis (heads and
                FFN columns spread across it; the decode cache's sequence).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


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
