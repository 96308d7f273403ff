"""Uniform model API. Port of ``repro.models.api``: ``build_model``,
``needs_source``, ``source_spec`` and ``input_specs`` (as shapes and
dtypes: the port has no abstract arrays; a decode cell's cache is built on
the ``meta`` device, so a full-size cell allocates nothing) and
``lm_loss``."""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (is_dtensor, local_chunk, replicate_where,
                                              shard_range)

from .config import ModelConfig, ShapeSpec
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


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The ``(shape, dtype)`` of every model input of one (arch, shape)
    cell: ``tokens`` (and ``labels`` to train) [B, S] int32, a source
    where the model reads one; a decode cell's ``tokens`` [B] and the cache
    of length S, leaf for leaf as ``init_cache`` makes it."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": ((b, s), i32)}
        if shape.kind == "train":
            specs["labels"] = ((b, s), i32)
        if needs_source(cfg):
            specs["source"] = source_spec(cfg, b)
        return specs
    # decode: one new token against a cache of length s
    src_len = cfg.source_len if needs_source(cfg) else None
    cache = build_model(cfg, device="meta").init_cache(b, s, src_len)
    return {"tokens": ((b,), i32),
            "cache": {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}}


def lm_loss(model, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            source: torch.Tensor | None = None, *, aux_weight: float = 0.01,
            remat: bool = True) -> torch.Tensor:
    """Causal-LM cross entropy plus the MoE load-balance loss:
    ``mean(logsumexp(logits) - logits[label]) + aux_weight * aux``, [] f32.

    Each label's logit is picked, as in the reference, by a masked sum over
    the vocab, so a vocab-sharded ``DTensor`` of logits stays sharded (a
    partial sum, then one small reduction), where a ``gather`` would leave
    a value DTensor cannot combine. The sum has one nonzero term, so on
    plain tensors it is bit for bit the ``gather``."""
    kw = {"source": source} if source is not None else {}
    logits, aux = model.forward(params, tokens, remat=remat, **kw)
    logz = torch.logsumexp(logits, dim=-1)
    return torch.mean(logz - _pick(logits, labels)) + aux_weight * aux


def _pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` as a masked sum over the vocab. On a
    ``DTensor`` it runs on each process's shard: its rows, and the labels
    among its vocab slice, a partial sum over the mesh dims that shard the
    vocab. Left to DTensor, the mask (the vocab against every label, whole
    on each process) makes the product gather the logits' vocab: [B, S, V]
    float32 a process."""
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    if not is_dtensor(logits):
        return torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    v = logits.dim() - 1
    logits = replicate_where(logits, lambda i, pl: pl.is_partial())
    mesh, pls = logits.device_mesh, list(logits.placements)
    rows = [pl if pl.is_shard() and pl.dim != v else Replicate() for pl in pls]
    lab = (labels.redistribute(mesh, rows).to_local() if is_dtensor(labels)
           else local_chunk(labels, rows, mesh))
    lo, n = shard_range(logits.shape[-1], pls, mesh, v)
    local = logits.to_local(grad_placements=pls)
    picked = torch.where(vocab[lo:lo + n] == lab[..., None], local, 0.0).sum(dim=-1)
    out = [Partial() if pl.is_shard(v) else p for pl, p in zip(pls, rows)]
    return DTensor.from_local(picked, mesh, out, run_check=False, shape=logits.shape[:-1],
                              stride=torch.empty(logits.shape[:-1], device="meta").stride())
