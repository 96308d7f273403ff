"""Continuous-batching serving example of the PyTorch/CUDA port.

A ragged Poisson trace flows through the slot pool -> scheduler -> chunked
prefill -> ragged decode pipeline: requests of mixed prompt/output lengths
share a fixed pool of KV slots, retire mid-flight, and freed slots backfill
from the admission queue, while the decode step keeps one static batch
shape throughout. ``decode_ticks=4`` fuses 4 decode ticks into each
dispatch (on-device EOS/budget retirement keeps outputs exact), so the
host syncs once per 4 tokens: watch ``dispatches_per_token`` in the
summary line.

Run:  PYTHONPATH=src python examples/torch_serve_continuous.py [--device cpu]
(the GPU by default; with no GPU it raises unless ``--device cpu``).
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, poisson_trace


def run(device, *, params: dict | None = None) -> dict:
    """Reduced llama2-7b: the trace through the continuous engine, then
    request 0 alone through the lock-step engine. ``params``: the model's
    tree (default: its init from seed 0)."""
    cfg = get_config("llama2-7b", reduced=True)
    model = build_model(cfg, device=device)
    params = model.init_params(0) if params is None else params

    trace = poisson_trace(n_requests=8, vocab_size=cfg.vocab_size,
                          prompt_len=(4, 24), max_new=(3, 16), seed=7)
    eng = ContinuousBatchingEngine(model, params, n_slots=3, max_len=64,
                                   chunk=8, decode_ticks=4)
    eng.warmup()
    report = eng.run(trace)

    agg = report["aggregate"]
    print(f"{agg['n_retired']} requests, {agg['generated_tokens']} tokens, "
          f"{agg['tokens_per_s']} tok/s, occupancy {agg['mean_occupancy']}, "
          f"ttft p50 {agg['ttft_p50_s']}s, "
          f"{agg['dispatches_per_token']} dispatches/token "
          f"({agg['host_syncs']} host syncs)")
    for r in sorted(report["requests"], key=lambda r: r["rid"]):
        print(f"  req {r['rid']}: prompt {r['prompt_len']:3d} -> "
              f"{r['n_tokens']:3d} tokens ({r['finish_reason']}) "
              f"{r['tokens'][:6]}{'...' if r['n_tokens'] > 6 else ''}")

    # spot-check: continuous output == single-request lock-step (greedy)
    ref_eng = ServingEngine(model, params, max_len=64, batch=1)
    req = trace[0]
    ref = ref_eng.generate(torch.as_tensor(req.prompt, device=model.device)[None],
                           steps=req.max_new_tokens)[0]
    got = next(r["tokens"] for r in report["requests"] if r["rid"] == req.rid)
    same = got == ref.tolist()
    print("continuous == per-request greedy (req 0):", same)
    assert same
    return {"aggregate": agg,
            "tokens": {r["rid"]: list(r["tokens"]) for r in report["requests"]},
            "same": same}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
