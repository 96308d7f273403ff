"""The port's training examples (``examples/torch_train_lm.py``,
``examples/torch_multi_arch_smoke.py``) on the CPU (``--device cpu``),
each held against the reference:

* train_lm (``--steps 10 --d-model 64 --layers 2 --seq-len 32 --batch 4
  --vocab 512``, the injected failure at step 4 with no checkpoint yet, so
  the loop restarts from the initial parameters): from the reference's
  initial parameters (converted), the loss history, the repeated steps
  among it, within 2e-5 relative of the reference ``TrainLoop``'s on the
  same flags; the example's own assertion (the loss falls) holds;
* multi_arch_smoke: all 10 assigned architectures run from the port's
  seeded draws; olmoe-1b-7b and whisper-small again on the reference's
  converted params, tokens and source: the loss within 1e-5 relative and
  the 4 greedy tokens after the AdamW step equal the reference's
  ``value_and_grad(lm_loss)``, ``adamw_update`` (lr 1e-3) and
  ``ServingEngine.generate``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.models.api import lm_loss as jax_lm_loss
from repro.models.api import needs_source as jax_needs_source
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.serving import ServingEngine as JaxServingEngine
from repro.train import TrainLoop as JaxTrainLoop
from repro.train import make_train_step as jax_make_train_step
from repro_torch.convert import from_jax
from test_torch_examples import load_example

TRAIN_FLAGS = dict(steps=10, d_model=64, layers=2, seq_len=32, batch=4, vocab=512)
LOSS_RTOL = 2e-5
SMOKE_RTOL = 1e-5
SMOKE_HELD = ("olmoe_1b_7b", "whisper_small")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_train(tmp_path, cfg) -> tuple[list[dict], dict]:
    """The reference's ``TrainLoop`` on the example's flags, its failure at
    step 4; and its initial parameters (PRNGKey(0), as its loop draws them)
    as numpy arrays."""
    jm = jax_build_model(cfg)
    step = jax_make_train_step(jm, base_lr=1e-3, warmup=20, total_steps=TRAIN_FLAGS["steps"])
    armed = {"on": True}

    def injector(s):
        if armed["on"] and s == int(TRAIN_FLAGS["steps"] * 0.4):
            armed["on"] = False
            raise RuntimeError("injected node failure")

    loop = JaxTrainLoop(jm, cfg, step, seq_len=TRAIN_FLAGS["seq_len"],
                        global_batch=TRAIN_FLAGS["batch"], ckpt_dir=str(tmp_path / "jax"),
                        ckpt_every=25, failure_injector=injector)
    return loop.run(TRAIN_FLAGS["steps"]), jax.tree.map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))


def test_train_lm_against_the_reference(tmp_path):
    ex = load_example("torch_train_lm")
    cfg = ex.config(d_model=TRAIN_FLAGS["d_model"], layers=TRAIN_FLAGS["layers"],
                    vocab=TRAIN_FLAGS["vocab"])
    jcfg = jax_get_config("qwen3-8b").replace(**{
        f: getattr(cfg, f) for f in ("d_model", "n_layers", "n_heads", "n_kv_heads",
                                     "head_dim", "d_ff", "vocab_size", "compute_dtype")})
    want, init = _reference_train(tmp_path, jcfg)
    got = ex.run("cpu", **TRAIN_FLAGS, ckpt_dir=str(tmp_path / "torch"),
                 params=from_jax(init, "cpu"))
    steps = [h["step"] for h in got["history"]]
    assert steps == [h["step"] for h in want] == [0, 1, 2, 3] + list(range(10))
    np.testing.assert_allclose(got["losses"], [h["loss"] for h in want], rtol=LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]


def _reference_smoke(arch: str) -> tuple[dict, dict]:
    """The reference example's step and generation for ``arch``: (its
    inputs as numpy arrays, {loss, tokens})."""
    cfg = jax_get_config(arch, reduced=True)
    jm = jax_build_model(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 17), 0, cfg.vocab_size)
    src = None
    if jax_needs_source(cfg):
        src = jax.random.normal(jax.random.PRNGKey(2), (2, cfg.source_len, cfg.d_model),
                                jnp.dtype(cfg.compute_dtype)) * 0.02
    given = {"params": from_jax(jax.tree.map(np.asarray, params), "cpu"),
             "tokens": np.array(toks)}
    if src is not None:
        given["source"] = torch.from_numpy(np.array(src))
    loss, grads = jax.value_and_grad(
        lambda p: jax_lm_loss(jm, p, toks[:, :-1], toks[:, 1:], src, remat=False))(params)
    params, _, _ = jax_adamw_update(params, grads, jax_adamw_init(params),
                                    lr=jnp.float32(1e-3))
    eng = JaxServingEngine(jm, params, max_len=32, batch=2,
                           source_len=cfg.source_len if src is not None else None)
    out = eng.generate(toks[:, :8], steps=4, source=src)
    return given, {"loss": float(loss), "tokens": np.asarray(out)}


def test_multi_arch_smoke_against_the_reference():
    ex = load_example("torch_multi_arch_smoke")
    ran = ex.main(["--device", "cpu"])
    assert list(ran) == list(JAX_ASSIGNED_ARCHS)
    for arch, r in ran.items():
        assert np.isfinite(r["loss"]) and r["tokens"].shape == (2, 4), arch
    refs = {arch: _reference_smoke(arch) for arch in SMOKE_HELD}
    got = ex.run("cpu", archs=SMOKE_HELD, given={a: g for a, (g, _) in refs.items()})
    for arch, (_, want) in refs.items():
        assert got[arch]["loss"] == pytest.approx(want["loss"], rel=SMOKE_RTOL), arch
        np.testing.assert_array_equal(got[arch]["tokens"], want["tokens"], err_msg=arch)
