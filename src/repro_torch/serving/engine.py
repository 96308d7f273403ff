"""Batched lock-step serving engine: prefill once, then per-token decode
steps — the paper's workload. Port of ``repro.serving.engine``.

Greedy decoding is held token for token to the reference. Sampling draws
from a seeded ``torch.Generator``; it cannot match ``jax.random``'s stream
and is held to replay only (same generator seed, same tokens)."""
from __future__ import annotations

import torch

from repro_torch.models.quantized import quantize_params


class ServingEngine:
    def __init__(self, model, params: dict, *, max_len: int, batch: int):
        if model.cfg.w4a8_serve:
            # +w4a8 config: one-shot weight quantization at construction
            # (deterministic); the KV side is init_cache's int8 default
            params = quantize_params(params)
        self.model, self.params = model, params
        self.max_len, self.batch = max_len, batch

    def new_cache(self) -> dict:
        return self.model.init_cache(self.batch, self.max_len)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, *, steps: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 eos_id: int | None = None, pad_id: int = 0) -> torch.Tensor:
        """prompts: [B, P] int (uniform length). Returns [B, steps] int32 on
        the model's device.

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
        cache = self.new_cache()
        logits, cache = self.model.prefill(self.params, prompts, cache)
        active = torch.ones((b,), dtype=torch.bool, device=dev)
        tok = self._sample(logits, temperature, generator)
        outs = []
        for _ in range(steps):
            outs.append(torch.where(active, tok, pad_id))
            if eos_id is not None:
                active &= tok != eos_id
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = torch.where(active, self._sample(logits, temperature, generator), tok)
        if not outs:
            return torch.empty((b, 0), dtype=torch.int32, device=dev)
        return torch.stack(outs, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None) -> torch.Tensor:
        if temperature == 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
