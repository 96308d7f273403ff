"""Process-wide distribution context. Port of ``repro.distributed.context``.

Model code (the expert-parallel MoE, the sequence-parallel decode
attention) needs the mesh to find its process groups, but models are
mesh-agnostic by design. Code that runs a model on a mesh (a sharded train
step, the multi-process tests) installs a ``DeviceMesh`` and the axis roles
here; model code consults the context and runs the single-process math
when none is set (tests, one card, and the launchers, which, as the
reference's, only enter the mesh).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``("data", "model")`` or ``("pod", "data", "model")``, as
``launch/mesh.py`` builds them). A tensor that is not a ``DTensor`` counts
as replicated over every mesh dim, as ``DTensor`` itself counts it.
"""
from __future__ import annotations

from dataclasses import dataclass


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` maps names to sizes (the sharding rules read only that)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


# Calls of the model code's collectives and the bytes this process sent in
# them, counted where they are issued (reset, run, read: as the kernels'
# LAUNCHES): the sequence-parallel decode's state all-gather, the
# expert-parallel MoE's all-reduce of y.
COLLECTIVES = {"sp_all_gather": 0, "sp_all_gather_bytes": 0,
               "ep_all_reduce": 0, "ep_all_reduce_bytes": 0}


@dataclass
class DistContext:
    mesh: object | None = None           # a DeviceMesh
    batch_axes: tuple[str, ...] = ()     # token/batch sharding axes (DP)
    model_axis: str | None = None        # TP/EP/SP axis

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def axis_size(self, names) -> int:
        if self.mesh is None:
            return 1
        if isinstance(names, str):
            names = (names,)
        shape = mesh_shape(self.mesh)
        n = 1
        for a in names:
            n *= shape[a]
        return n

    def axis_index(self, names) -> int:
        """This process's index along ``names`` (row-major over several
        axes, as ``jax.lax.axis_index`` counts them)."""
        if isinstance(names, str):
            names = (names,)
        idx = 0
        for a in names:
            idx = idx * self.axis_size(a) + self.mesh.get_local_rank(a)
        return idx


_CTX = DistContext()


def set_context(mesh, batch_axes=("data",), model_axis="model") -> DistContext:
    global _CTX
    _CTX = DistContext(mesh=mesh, batch_axes=tuple(batch_axes), model_axis=model_axis)
    return _CTX


def clear_context() -> None:
    global _CTX
    _CTX = DistContext()


def get_context() -> DistContext:
    return _CTX
