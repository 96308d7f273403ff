"""Whisper-style encoder-decoder (the ``audio`` family). Port of
``repro.models.whisper``.

The conv/mel frontend is a stub, as in the reference: a source is
precomputed frame embeddings ``[S_src, d_model]``. The encoder is a
bidirectional ``TransformerLM`` (``causal=False``, no embedding) over the
frames, masked by each row's valid length; the decoder is a causal
``TransformerLM`` with a cross attention in every layer
(``cross_attn_every=1``).

Every serving entry point forwards to the decoder with
``params["decoder"]``, so both engines drive an encoder-decoder through
the same calls as a decoder-only model. The encoder runs where a source
enters: in lock-step :meth:`prefill` over the batch's sources, and in
:meth:`ingest_source` once per distinct source of continuous serving,
before the decoder's cross layers project the encoding into the pool.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from .config import ModelConfig
from .transformer import Cache, Params, TransformerLM


class WhisperModel:
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        enc_cfg = cfg.replace(family="dense", cross_attn_every=0,
                              n_layers=cfg.encoder_layers, window=None)
        dec_cfg = cfg.replace(family="dense", cross_attn_every=1)
        self.encoder = TransformerLM(enc_cfg, device=self.device, causal=False,
                                     with_embedding=False)
        self.decoder = TransformerLM(dec_cfg, device=self.device)

    def init_params(self, seed: int = 0, *, dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters (``TransformerLM.init_params`` of each stack;
        the decoder from ``seed + 1``) in the reference's tree layout."""
        return {"encoder": self.encoder.init_params(seed, dtype=dtype),
                "decoder": self.decoder.init_params(seed + 1, dtype=dtype)}

    def encode(self, params: Params, source: torch.Tensor,
               source_len: torch.Tensor | None = None, *, remat: bool = True) -> torch.Tensor:
        """source [B, S, d] -> encodings [B, S, d]. ``source_len`` [B]:
        each row's valid frames; keys past it are masked, so the valid
        positions' encodings do not depend on the padding. ``remat``: see
        ``TransformerLM.forward``."""
        return self.encoder.forward(params["encoder"], embeds=source, kv_length=source_len,
                                    remat=remat)[0]

    def forward(self, params: Params, tokens: torch.Tensor, *, source: torch.Tensor,
                remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """Training forward: encode ``source`` [B, S_src, d], then the
        decoder over ``tokens`` [B, S] with the encoding as its source ->
        (logits [B, S, V] f32, aux loss)."""
        enc = self.encode(params, source, remat=remat)
        return self.decoder.forward(params["decoder"], tokens, source=enc, remat=remat)

    def init_cache(self, batch: int, max_len: int, source_len: int | None = None, *,
                   n_sources: int | None = None, chunk: int | None = None,
                   kv_dtype: torch.dtype | None = None) -> Cache:
        return self.decoder.init_cache(batch, max_len, source_len or self.cfg.source_len,
                                       n_sources=n_sources, chunk=chunk, kv_dtype=kv_dtype)

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Cache,
                source: torch.Tensor | None = None,
                source_len: torch.Tensor | None = None):
        if source is None:
            return self.decoder.prefill(params["decoder"], tokens, cache)
        if source_len is not None:
            source_len = torch.as_tensor(source_len, dtype=torch.int32, device=self.device)
        enc = self.encode(params, source.to(self.device), source_len)
        return self.decoder.prefill(params["decoder"], tokens, cache, source=enc,
                                    source_len=source_len)

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Cache,
                    active: torch.Tensor | None = None):
        return self.decoder.decode_step(params["decoder"], tokens, cache, active)

    def decode_multi(self, params: Params, *args, **kw):
        return self.decoder.decode_multi(params["decoder"], *args, **kw)

    # ---- continuous serving (the decoder's) --------------------------------
    def supports_ragged_serving(self) -> bool:
        return self.decoder.supports_ragged_serving()

    def prefill_chunk(self, params: Params, *args, **kw):
        return self.decoder.prefill_chunk(params["decoder"], *args, **kw)

    def prefill_chunks_batched(self, params: Params, *args, **kw):
        return self.decoder.prefill_chunks_batched(params["decoder"], *args, **kw)

    def finalize_slot(self, cache: Cache, slot: int, length: int) -> Cache:
        return self.decoder.finalize_slot(cache, slot, length)

    def release_slot(self, cache: Cache, slot: int) -> Cache:
        return self.decoder.release_slot(cache, slot)

    def ingest_source(self, params: Params, source: torch.Tensor, cache: Cache,
                      entry: int, length: int) -> Cache:
        """Encode the padded frames ``source`` [S_max, d] once (masked to
        ``length``), then pool the decoder's per-layer cross K/V of the
        encoding (``TransformerLM.ingest_source``)."""
        lens = torch.full((1,), length, dtype=torch.int32, device=self.device)
        enc = self.encode(params, source[None].to(self.device), lens)[0]
        return self.decoder.ingest_source(params["decoder"], enc, cache, entry, length)

    def assign_source(self, cache: Cache, slot: int, entry: int) -> Cache:
        return self.decoder.assign_source(cache, slot, entry)

    def release_source(self, cache: Cache, entry: int) -> Cache:
        return self.decoder.release_source(cache, entry)
