"""Load harness: Poisson / trace-driven request generation. Port of
``repro.serving.workload``: the same seed draws the same trace, in the same
order, as the reference's, so one trace drives both packages' engines.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .scheduler import Request

TRACE_SHAPES = ("poisson", "bursty", "heavy-tail")


def _arrivals(rng: np.random.Generator, n: int, rate: float | None,
              shape: str, burst: int, tail_alpha: float) -> np.ndarray:
    """Arrival-time vector for ``n`` requests at mean ``rate`` req/s.

    ``poisson`` is the well-behaved baseline (i.i.d. exponential gaps —
    the exact draw order the pre-shape trace generator used, so existing
    seeded traces replay unchanged). ``bursty`` models synchronized client
    behavior: bursts of ``burst`` requests arrive nearly back-to-back
    (intra-burst gaps ~20x tighter than the mean), with burst *starts*
    Poisson at ``rate / burst`` so the long-run rate still averages
    ``rate`` — the queue sees deep instantaneous overload even when the
    mean load is feasible. ``heavy-tail`` draws Lomax (Pareto-II) gaps
    with shape ``tail_alpha`` scaled to the same mean: most gaps are tiny
    (clumps) but occasional huge gaps drain the queue — the
    high-variance regime where admission control earns its keep."""
    if rate is None:
        return np.zeros(n)
    if shape == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, n))
    if shape == "bursty":
        n_bursts = -(-n // burst)
        starts = np.cumsum(rng.exponential(burst / rate, n_bursts))
        gaps = rng.exponential(1.0 / (rate * 20.0), n)
        out = np.empty(n)
        for b in range(n_bursts):
            lo, hi = b * burst, min(n, (b + 1) * burst)
            out[lo:hi] = starts[b] + np.cumsum(gaps[lo:hi])
        return out
    if shape == "heavy-tail":
        if tail_alpha <= 1.0:
            raise ValueError("tail_alpha must be > 1 (finite-mean Lomax)")
        scale = (tail_alpha - 1.0) / rate        # Lomax mean = scale/(a-1)
        return np.cumsum(rng.pareto(tail_alpha, n) * scale)
    raise ValueError(f"unknown trace shape {shape!r} "
                     f"(known: {TRACE_SHAPES})")


def poisson_trace(*, n_requests: int, vocab_size: int,
                  rate: float | None = None,
                  prompt_len: tuple[int, int] = (8, 48),
                  max_new: tuple[int, int] = (4, 128),
                  seed: int = 0,
                  source_len: tuple[int, int] | None = None,
                  source_dim: int = 0,
                  source_share: int = 0,
                  shape: str = "poisson",
                  burst: int = 8,
                  tail_alpha: float = 1.5) -> list[Request]:
    """Ragged trace: prompt lengths and output budgets drawn uniformly from
    their ranges (mixed-length — the shape production traffic actually has),
    arrivals at mean ``rate`` req/s (``None``: all backlogged at t=0) with
    the interarrival ``shape`` of :func:`_arrivals` — ``"poisson"``
    (default, the historical behavior, bit-identical draws for a given
    seed), ``"bursty"`` (``burst``-sized near-simultaneous clumps), or
    ``"heavy-tail"`` (Lomax gaps, ``tail_alpha``) for overload testing.

    ``source_len`` + ``source_dim`` attach a cross-attention source to every
    request: ``[L, source_dim]`` float32 features with L drawn uniformly
    from the range — *heterogeneous* encoder lengths, the shape mixed
    vision/audio traffic has. ``source_share`` > 1 reuses each generated
    source (and its ``source_id``) across that many consecutive requests —
    e.g. N questions about one image — exercising the source-KV pool's
    refcounted dedup."""
    rng = np.random.default_rng(seed)
    arrivals = _arrivals(rng, n_requests, rate, shape, burst, tail_alpha)
    reqs = []
    src, sid = None, None
    for i in range(n_requests):
        p = int(rng.integers(prompt_len[0], prompt_len[1], endpoint=True))
        if source_len is not None and source_dim:
            if src is None or source_share < 2 or i % source_share == 0:
                ln = int(rng.integers(source_len[0], source_len[1],
                                      endpoint=True))
                src = (rng.standard_normal((ln, source_dim))
                       .astype(np.float32) * 0.02)
                sid = f"src-{i}" if source_share > 1 else None
        reqs.append(Request(
            prompt=rng.integers(0, vocab_size, p).astype(np.int32),
            max_new_tokens=int(rng.integers(max_new[0], max_new[1],
                                            endpoint=True)),
            rid=i, arrival=float(arrivals[i]), source=src, source_id=sid))
    return reqs


def load_trace(path: str | Path, vocab_size: int) -> list[Request]:
    """Trace file: JSON list of {"prompt_len" | "prompt", "max_new_tokens",
    "arrival"?} records. ``prompt_len`` entries get deterministic synthetic
    token ids (seeded per record) clipped to the vocab."""
    records = json.loads(Path(path).read_text())
    reqs = []
    for i, rec in enumerate(records):
        if "prompt" in rec:
            prompt = np.asarray(rec["prompt"], np.int32) % vocab_size
        else:
            rng = np.random.default_rng(rec.get("seed", i))
            prompt = rng.integers(0, vocab_size,
                                  int(rec["prompt_len"])).astype(np.int32)
        reqs.append(Request(prompt=prompt,
                            max_new_tokens=int(rec["max_new_tokens"]),
                            rid=rec.get("rid", i),
                            arrival=float(rec.get("arrival", 0.0))))
    return reqs
