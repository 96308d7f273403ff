"""Deterministic, counted synthetic token pipeline. Port of
``repro.data.pipeline``.

Every batch is a pure function of (seed, step): a resumed or retried run
regenerates the exact step stream with no data state to save. Tokens come
from a Zipf-like unigram distribution with a weak Markov jitter, drawn
through ``core/prng.py``, the mirror of ``jax.random``'s Threefry streams,
so tokens and labels are bit for bit the reference's for any (vocab,
seq_len, batch, seed, step).

The unigram draw is ``categorical`` over a ``[B, S + 1, V]`` Gumbel draw
(1.05 GB of float32 at V 32000, B 8, S 1024): it is made a piece of rows
at a time, which leaves the values unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import prng


@dataclass(frozen=True)
class SyntheticTokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_for_step(self, step: int, device: str | torch.device = "cpu") -> dict:
        return batch_for_step(self.vocab_size, self.seq_len, self.global_batch,
                              self.seed, step, device=device)


def batch_for_step(vocab: int, seq_len: int, batch: int, seed: int, step: int, *,
                   device: str | torch.device = "cpu") -> dict:
    """{tokens, labels} [batch, seq_len] int32 on ``device``: labels are the
    tokens shifted by one (causal LM)."""
    key = prng.fold_in(prng.prng_key(seed, device), step)
    k1, k2 = prng.split(key)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    logits = -1.1 * torch.log(ranks)
    shape = (batch, seq_len + 1)
    toks = prng.categorical(k1, logits, shape)
    # weak Markov structure: token t moves by a running sum of earlier parities
    shift = torch.cumsum(toks % 7, dim=1, dtype=torch.int32) % vocab
    jitter = prng.uniform(k2, shape, torch.float32, 0.0, 1.0) < 0.25
    toks = (toks + shift * jitter) % vocab
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def source_for_step(cfg, batch: int, seed: int, step: int, *,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """Stub-frontend features (vision patch or audio frame embeddings)
    [batch, source_len, d_model] in the compute dtype."""
    key = prng.fold_in(prng.prng_key(seed ^ 0x5EED, device), step)
    dtype = getattr(torch, cfg.compute_dtype)
    scale = torch.tensor(0.02, dtype=dtype, device=device)   # rounded to dtype, as JAX's
    return prng.normal(key, (batch, cfg.source_len, cfg.d_model), dtype) * scale
