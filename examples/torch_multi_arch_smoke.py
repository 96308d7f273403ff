"""Run every assigned architecture (reduced config) of the PyTorch/CUDA port
through one train step (``lm_loss`` with autograd, then AdamW) and a short
greedy generation: the 10-arch support matrix as a runnable script.

Run:  PYTHONPATH=src python examples/torch_multi_arch_smoke.py [--device cpu]
(the GPU by default; with no GPU it raises unless ``--device cpu``).
"""
import argparse
import time

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model, lm_loss, needs_source
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.serving import ServingEngine
from repro_torch.tree import tree_leaves, tree_map

B, S = 2, 16


def inputs(cfg, device) -> dict:
    """An arch's params (its init from seed 0), its [B, S + 1] tokens (a
    generator seeded 1) and, where the model reads one, its [B, S_src, d]
    source (normal from seed 2, times 0.02)."""
    device = torch.device(device)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    out = {"params": model.init_params(0),
           "tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                                   device=device, dtype=torch.int32)}
    if needs_source(cfg):
        gen.manual_seed(2)
        out["source"] = (torch.randn((B, cfg.source_len, cfg.d_model), generator=gen,
                                     device=device)
                         * 0.02).to(getattr(torch, cfg.compute_dtype))
    return out


def run(device, *, archs=ASSIGNED_ARCHS, given: dict | None = None) -> dict:
    """Each arch of ``archs``: one train step and 4 greedy steps. ``given``:
    {arch: {"params", "tokens"[, "source"]}} used in place of
    :func:`inputs` (the params are updated in place)."""
    device = torch.device(device)
    res = {}
    for arch in archs:
        t0 = time.perf_counter()
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg, device=device)
        got = (given or {}).get(arch) or inputs(cfg, device)
        params = got["params"]
        toks = torch.as_tensor(got["tokens"], dtype=torch.int32, device=device)
        src = got.get("source")
        src = None if src is None else torch.as_tensor(src, device=device)

        # one training step
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = tree_leaves(leaves)
        with torch.enable_grad():
            loss = lm_loss(model, leaves, toks[:, :-1], toks[:, 1:], src, remat=False)
            by_leaf = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        loss = float(loss.detach())
        grads = tree_map(lambda v: by_leaf[id(v)], leaves)
        opt = adamw_init(params)
        params, opt, _ = adamw_update(params, grads, opt,
                                      lr=torch.tensor(1e-3, device=device))

        # short generation
        eng = ServingEngine(model, params, max_len=32, batch=B,
                            source_len=cfg.source_len if src is not None else None)
        out = eng.generate(toks[:, :8], steps=4, source=src)

        secs = time.perf_counter() - t0
        print(f"{arch:24s} loss={loss:7.3f} gen={tuple(out.shape)} ({secs:.1f}s)")
        res[arch] = {"loss": loss, "tokens": out.cpu().numpy(), "seconds": secs}
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
