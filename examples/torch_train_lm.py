"""End-to-end training example of the PyTorch/CUDA port: train a small
qwen3-family model on the synthetic pipeline, with checkpointing and a
mid-run simulated failure + resume (the fault-tolerance path, exercised).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] [--steps 200]
(the default is 7.3M params; --d-model 512 --layers 12, the size the
reference's docstring calls ~100M, is 46.1M by ``count_params``; the GPU
by default, and with no GPU it raises unless ``--device cpu``).
"""
import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.roofline import count_params
from repro_torch.models.api import build_model
from repro_torch.train import TrainLoop, make_train_step


def config(*, d_model: int, layers: int, vocab: int):
    """The qwen3-8b family shrunk to ``d_model`` x ``layers``, float32."""
    return get_config("qwen3-8b").replace(
        d_model=d_model, n_layers=layers,
        n_heads=max(4, d_model // 64), n_kv_heads=max(2, d_model // 128),
        head_dim=64, d_ff=d_model * 3, vocab_size=vocab,
        compute_dtype="float32")


def run(device, *, steps: int = 200, d_model: int = 256, layers: int = 4, seq_len: int = 256,
        batch: int = 8, vocab: int = 8192, ckpt_dir: str | None = None,
        inject_failure: bool = True, params: dict | None = None) -> dict:
    """``steps`` of ``TrainLoop``, one injected failure 40% of the way in.
    ``params``: the initial tree (default: the model's seeded init)."""
    cfg = config(d_model=d_model, layers=layers, vocab=vocab)
    model = build_model(cfg, device=device)
    total, _ = count_params(cfg)
    print(f"model: {cfg.name}-family reduced, {total / 1e6:.1f}M params")

    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    step_fn = make_train_step(model, base_lr=1e-3, warmup=20, total_steps=steps)

    # one injected transient failure at step 40% through -> the loop restores
    # from the last checkpoint and continues (deterministic data stream)
    boom = {"armed": inject_failure}
    fail_at = int(steps * 0.4)

    def injector(step):
        if boom["armed"] and step == fail_at:
            boom["armed"] = False
            raise RuntimeError(f"injected node failure at step {step}")

    loop = TrainLoop(model, cfg, step_fn, seq_len=seq_len, global_batch=batch,
                     ckpt_dir=ckpt_dir, ckpt_every=25, failure_injector=injector,
                     params=params)
    history = loop.run(steps)

    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"steps={len(history)} loss {first:.3f} -> {last:.3f} "
          f"(ckpt_dir={ckpt_dir})")
    assert last < first, "loss should decrease"
    print("training (with failure/resume) completed")
    return {"params": total, "history": history, "losses": [h["loss"] for h in history],
            "ckpt_dir": ckpt_dir}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--inject-failure", action="store_true", default=True)
    args = ap.parse_args(argv)
    return run(resolve_device(args.device), steps=args.steps, d_model=args.d_model,
               layers=args.layers, seq_len=args.seq_len, batch=args.batch,
               vocab=args.vocab, ckpt_dir=args.ckpt_dir, inject_failure=args.inject_failure)


if __name__ == "__main__":
    main()
