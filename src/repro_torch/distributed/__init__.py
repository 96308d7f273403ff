"""The distribution layer's serving half: the process-wide context
(``context``), the sharding rules (``sharding``) and the sequence-parallel
decode attention (``sp_attention``). Port of ``repro.distributed``."""
from .sharding import MeshRules, batch_specs, cache_specs, mesh_axis_names, param_specs

__all__ = ["MeshRules", "batch_specs", "cache_specs", "mesh_axis_names", "param_specs"]
