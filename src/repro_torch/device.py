"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``, as the CPU tests do). There is no silent fallback: with
no device given and no GPU present, :func:`resolve_device` raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises if no GPU is present); anything else is
    taken as given. Also pins float32 matmul precision (see below)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run the plain versions on "
                "the CPU")
        device = "cuda"
    device = torch.device(device)
    # float32 matmuls and convolutions in full float32: TF32 keeps ~3
    # decimal digits, which would make the port's float32 results differ
    # from the reference's by more than the parity tolerances allow
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
