"""Parameter conversion from the reference's pytree to the port's.

The reference keeps parameters as nested dicts of arrays with stacked
``[L, ...]`` layer axes (a vision stack's ``cross_blocks`` among them, an
encoder-decoder's ``encoder`` and ``decoder`` trees); so does the port. ``from_jax`` takes that tree as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's side —
this module never sees a JAX array) and returns the same tree of tensors,
leaf for leaf, with no transpose: weights stay ``[K, N]`` and are used as
``x @ W``. The W4A8 leaves ``name__qp`` (uint8 packed int4) and
``name__qs`` (float32 group scales) convert as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import AdamWState


def _to_tensor(a: np.ndarray, device: torch.device, dtype: torch.dtype | None,
               name: str) -> torch.Tensor:
    a = np.array(a)                        # a writable copy of the caller's array
    if a.dtype.name == "bfloat16":         # ml_dtypes bfloat16: no numpy twin
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    # ``dtype`` applies to float weights; group scales stay float32
    if dtype is not None and t.is_floating_point() and not name.endswith("__qs"):
        t = t.to(dtype)
    return t.to(device)


def from_jax(params_np, device: str | torch.device, dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``. ``dtype`` (optional) casts the floating-point leaves other
    than the ``__qs`` scales. The reference's ``AdamWState`` (its leaves
    as numpy) converts to the port's, moments as they are, so both
    packages can start from one optimizer state."""
    device = torch.device(device)
    if getattr(params_np, "_fields", None) == AdamWState._fields:
        return AdamWState(step=_to_tensor(params_np.step, device, None, "step"),
                          mu=from_jax(params_np.mu, device), nu=from_jax(params_np.nu, device))
    out = {}
    for name, leaf in params_np.items():
        if isinstance(leaf, dict):
            out[name] = from_jax(leaf, device, dtype)
        else:
            out[name] = _to_tensor(leaf, device, dtype, name)
    return out
