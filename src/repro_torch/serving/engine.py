"""Batched lock-step serving engine: prefill once, then per-token decode
steps — the paper's workload. Port of ``repro.serving.engine``.

Greedy and sampled tokens are held token for token to the reference:
sampling draws as ``jax.random.categorical`` does, Gumbel-max over the
reference's key stream (``core/prng.py`` mirrors its Threefry bits)."""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.models.quantized import quantize_params


class ServingEngine:
    def __init__(self, model, params: dict, *, max_len: int, batch: int,
                 source_len: int | None = None):
        if model.cfg.w4a8_serve:
            # +w4a8 config: one-shot weight quantization at construction
            # (deterministic); the KV side is init_cache's int8 default
            params = quantize_params(params)
        self.model, self.params = model, params
        self.max_len, self.batch = max_len, batch
        self.source_len = source_len

    def new_cache(self) -> dict:
        if self.source_len is None:
            return self.model.init_cache(self.batch, self.max_len)
        return self.model.init_cache(self.batch, self.max_len, self.source_len)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, *, steps: int,
                 temperature: float = 0.0, rng: torch.Tensor | None = None,
                 eos_id: int | None = None, pad_id: int = 0,
                 source: torch.Tensor | None = None,
                 source_len: torch.Tensor | None = None) -> torch.Tensor:
        """prompts: [B, P] int (uniform length). Returns [B, steps] int32 on
        the model's device.

        ``rng``: a :mod:`~repro_torch.core.prng` key (default
        ``prng_key(0)``, the reference's ``PRNGKey(0)``). The first token is
        drawn with ``rng`` itself; before each decode step the key splits as
        ``jax.random.split`` does, ``rng, sub = fold_in(rng, 0), fold_in(rng,
        1)``, and the step's token is drawn with ``sub``.

        ``source`` [B, S_src, d]: a cross-attention model's sources, padded
        to one S_src (the engine's ``source_len``); ``source_len`` [B]:
        their true lengths, masked in prefill and, through the cache, at
        every decode step, so rows of different source lengths batch
        together.

        A row that emits ``eos_id`` is retired: the EOS token itself is
        emitted, every later step emits ``pad_id``, and the row's decode
        output is frozen (it still rides through the lock-step batch)."""
        b, p = prompts.shape
        if b != self.batch or p + steps > self.max_len:
            raise ValueError(f"generate: prompts {tuple(prompts.shape)} + {steps} "
                             f"steps do not fit batch={self.batch}, "
                             f"max_len={self.max_len}")
        dev = self.model.device
        prompts = prompts.to(dev)
        sampled = temperature != 0.0
        if sampled:
            rng = prng.prng_key(0, device=dev) if rng is None else rng.to(dev)
        cache = self.new_cache()
        if source is not None:
            source = source.to(dev)
            if source_len is not None:
                source_len = torch.as_tensor(source_len, dtype=torch.int32, device=dev)
            logits, cache = self.model.prefill(self.params, prompts, cache, source, source_len)
        else:
            logits, cache = self.model.prefill(self.params, prompts, cache)
        active = torch.ones((b,), dtype=torch.bool, device=dev)
        tok = self._sample(logits, temperature, rng)
        outs = []
        for _ in range(steps):
            outs.append(torch.where(active, tok, pad_id))
            if eos_id is not None:
                active &= tok != eos_id
            sub = None
            if sampled:       # a greedy run reads no key: skip the hashing
                rng, sub = prng.fold_in(rng, 0), prng.fold_in(rng, 1)
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = torch.where(active, self._sample(logits, temperature, sub), tok)
        if not outs:
            return torch.empty((b, 0), dtype=torch.int32, device=dev)
        return torch.stack(outs, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                key: torch.Tensor | None) -> torch.Tensor:
        """``jax.random.categorical(key, logits / temperature)``: the argmax
        of the scaled logits plus one f32 Gumbel draw per entry. The
        temperature divides as a tensor: CUDA turns a division by a Python
        scalar into a multiply by its reciprocal."""
        if temperature == 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        scaled = logits / torch.full_like(logits, temperature)
        return (scaled + prng.gumbel(key, tuple(logits.shape))).argmax(dim=-1).to(torch.int32)
