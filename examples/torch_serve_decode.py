"""Serving example of the PyTorch/CUDA port: batched prefill + per-token
SwiftKV decode (the paper's workload), comparing the decode-attention impls
and the incremental-RoPE (Eq. 11) decode state against direct
recomputation. With ``decode_impl="kernel"`` on the GPU every decode
attention goes through the hand-written CUDA kernel
(``kernels/swiftkv_decode/ops.py``).

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu] [--gen 32]
(the GPU by default; with no GPU it raises unless ``--device cpu``).
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine

IMPLS = ("blockwise", "tokenwise", "kernel", "naive")
BATCH, PROMPT_LEN = 4, 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device, *, gen: int = 32, params: dict | None = None, prompts=None) -> dict:
    """Reduced gemma-2b (MQA) served by each decode impl, then by each RoPE
    mode, ``gen`` greedy steps. ``params``: the model's tree (default: its
    init from seed 0); ``prompts``: [batch, prompt_len] token ids (default:
    BATCH x PROMPT_LEN drawn from a generator seeded 1)."""
    device = torch.device(device)
    cfg = get_config("gemma-2b", reduced=True)
    if params is None:
        params = build_model(cfg, device=device).init_params(0)
    if prompts is None:
        draw = torch.Generator(device=device).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=draw,
                                device=device, dtype=torch.int32)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    batch = prompts.shape[0]

    outs, tok_s, launches = {}, {}, {}
    for impl in IMPLS:
        model = build_model(cfg.replace(decode_impl=impl), device=device)
        eng = ServingEngine(model, params, max_len=64, batch=batch)
        _ = eng.generate(prompts, steps=2)        # warm
        before = sum(LAUNCHES.values())
        _sync(device)
        t0 = time.perf_counter()
        outs[impl] = eng.generate(prompts, steps=gen).cpu()
        _sync(device)
        dt = time.perf_counter() - t0
        launches[impl] = sum(LAUNCHES.values()) - before
        tok_s[impl] = batch * gen / dt
        print(f"decode_impl={impl:10s} {tok_s[impl]:8.1f} tok/s")

    for impl in IMPLS[1:]:
        same = torch.equal(outs["blockwise"], outs[impl])
        print(f"greedy tokens blockwise == {impl}: {same}")
        assert same, (impl, outs["blockwise"][:, :8], outs[impl][:, :8])

    # incremental vs direct RoPE decode state
    for mode in ("incremental", "direct"):
        model = build_model(cfg.replace(rope_mode=mode), device=device)
        eng = ServingEngine(model, params, max_len=64, batch=batch)
        outs[mode] = eng.generate(prompts, steps=gen).cpu()
    rope_same = torch.equal(outs["incremental"], outs["direct"])
    print("greedy tokens incremental-RoPE == direct-RoPE:", rope_same)
    return {"tokens": {k: v.numpy() for k, v in outs.items()}, "tokens_per_s": tok_s,
            "launches": launches, "rope_same": rope_same}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args(argv)
    return run(resolve_device(args.device), gen=args.gen)


if __name__ == "__main__":
    main()
