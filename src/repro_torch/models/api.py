"""Uniform model API. Port of ``repro.models.api.build_model`` (dense
family only; the others raise ``NotImplementedError``)."""
from __future__ import annotations

import torch

from .config import ModelConfig
from .transformer import TransformerLM


def build_model(cfg: ModelConfig, *,
                device: str | torch.device | None = None) -> TransformerLM:
    """The model of ``cfg`` on ``device`` (default: the GPU; raises if no
    GPU is present)."""
    return TransformerLM(cfg, device=device)
