"""Uniform model API. Port of ``repro.models.api``: ``build_model``,
``needs_source`` and ``source_spec`` (as a shape and dtype, the port has no
abstract arrays)."""
from __future__ import annotations

import torch

from .config import ModelConfig
from .transformer import TransformerLM
from .whisper import WhisperModel


def build_model(cfg: ModelConfig, *,
                device: str | torch.device | None = None) -> TransformerLM | WhisperModel:
    """The model of ``cfg`` on ``device`` (default: the GPU; raises if no
    GPU is present): the encoder-decoder for ``audio``, else the
    transformer stack."""
    if cfg.family == "audio":
        return WhisperModel(cfg, device=device)
    return TransformerLM(cfg, device=device)


def needs_source(cfg: ModelConfig) -> bool:
    """Whether the config's model reads a source (cross attention)."""
    return cfg.family in ("vlm", "audio")


def source_spec(cfg: ModelConfig, batch: int) -> tuple[tuple[int, int, int], torch.dtype]:
    """Shape and dtype of a batch's sources: [B, S_src, d] in the compute
    dtype."""
    return (batch, cfg.source_len, cfg.d_model), getattr(torch, cfg.compute_dtype)
