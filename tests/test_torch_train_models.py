"""The port's training loss and gradients against the reference's for the
dense and MoE configs at reduced size: ``models/api.py::lm_loss`` and
autograd against ``jax.value_and_grad`` of ``repro.models.api.lm_loss``,
on the reference's weights converted leaf for leaf and one counted batch
(``data/pipeline.py``, bitwise the reference's), float32.

Tolerances (``_torch_parity``): the loss within ``LOSS_RTOL`` (1e-6)
relative; each gradient leaf within ``GRAD_RTOL`` (2e-5) of that leaf's
largest reference gradient (measured: at most 1.4e-6). The reference runs
without remat, which changes none of its values
(``tests/test_perf_features.py::test_remat_policy_gradients_match``); the
port's remat ``"full"``, ``"dots"`` and off give equal losses and
gradients bit for bit. Also: the MoE load-balance term of ``forward``
against the reference's, gradients with dropped assignments, a train step
of 2 microbatches against the reference's accumulation and against 1
microbatch, and a training step after serving under inference mode."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (GRAD_RTOL, LOSS_RTOL, check_loss_and_grads, counted_batch,
                           jax_batch, jax_value_and_grad, pair)
from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.models.api import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model, lm_loss
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items

NAMES = ["llama2-7b", "chatglm-6b", "qwen3-8b", "gemma-2b", "mistral-nemo-12b",
         "h2o-danube-1.8b", "olmoe-1b-7b", "llama4-scout-17b-a16e"]
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_grads(name, counted_batch(pair(name)[2].cfg))


def test_moe_drops_loss_and_gradients_match_reference():
    """olmoe at capacity factor 1: assignments past an expert's capacity
    drop, and the gradient flows through the router weights and the
    dispatch copy of the kept ones only."""
    jcfg = jax_get_config("olmoe-1b-7b", reduced=True).replace(capacity_factor=1.0)
    jm = jax_build_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config("olmoe-1b-7b", reduced=True).replace(capacity_factor=1.0),
                     device="cpu")
    tparams = from_jax(jax.tree.map(np.asarray, params), "cpu")
    batch = counted_batch(tm.cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(jm, p, b["tokens"], b["labels"], remat=False)))(
        params, jax_batch(batch))
    loss, grads = _value_and_grad(
        lambda p, b: lm_loss(tm, p, b["tokens"], b["labels"]), tparams, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    want = dict(tree_items(jax.tree.map(np.asarray, want_grads)))
    for path, g in tree_items(grads):
        w = want[path]
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_RTOL * float(np.abs(w).max()), path
    # assignments did drop (capacity 8 per expert for 32 x 2 assignments):
    # the logits differ from the drop-free config's on the same weights
    logits, _ = tm.forward(tparams, batch["tokens"], remat=False)
    free, _ = pair("olmoe-1b-7b")[2].forward(tparams, batch["tokens"], remat=False)
    assert not torch.equal(logits, free)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "llama4-scout-17b-a16e", "llama2-7b"])
def test_forward_aux_loss_matches_reference(name):
    """``forward`` returns the load-balance loss summed over the layers
    (0 without experts), as the reference's does."""
    jm, params, tm, tparams = pair(name)
    toks = counted_batch(tm.cfg)["tokens"]
    logits, aux = tm.forward(tparams, toks, remat=False)
    jlogits, jaux = jax.jit(functools.partial(jm.forward, remat=False))(
        params, jnp.asarray(toks.numpy()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=0)
    assert (float(aux) > 0) == bool(tm.cfg.n_experts)


@pytest.mark.parametrize("name", ["qwen3-8b", "olmoe-1b-7b"])
def test_remat_policies_give_equal_bits(name):
    """Remat off, ``"full"`` and ``"dots"``: the same loss and gradients,
    bit for bit (a checkpoint reruns the same ops in backward)."""
    _, _, tm, tparams = pair(name)
    batch = counted_batch(tm.cfg)
    runs = []
    for policy, remat in (("full", False), ("full", True), ("dots", True)):
        model = build_model(tm.cfg.replace(remat_policy=policy), device="cpu")
        runs.append(_value_and_grad(
            lambda p, b: lm_loss(model, p, b["tokens"], b["labels"], remat=remat),
            tparams, batch))
    (loss0, grads0), rest = runs[0], runs[1:]
    for loss, grads in rest:
        assert torch.equal(loss, loss0)
        for (path, g), (_, g0) in zip(tree_items(grads), tree_items(grads0)):
            assert torch.equal(g, g0), path


def test_microbatches_match_reference_and_one_batch():
    """A train step over 2 microbatches of a batch of 4: its loss and
    gradient norm against the reference's ``lax.scan`` accumulation (the
    halves' losses and float32 gradients summed in order, then divided by
    2; each half through the reference's ``value_and_grad``), and against
    the port's 1-microbatch step on the same batch (one float32 rounding
    of the mean apart)."""
    jm, params, tm, tparams = pair("llama2-7b")
    batch = counted_batch(tm.cfg, b=2 * B)
    vg = jax_value_and_grad("llama2-7b")
    halves = [vg(params, {k: jnp.asarray(v[i * B:(i + 1) * B].numpy())
                          for k, v in batch.items()}) for i in range(2)]
    want_loss = (np.float32(0) + np.float32(halves[0][0]) + np.float32(halves[1][0])) / 2
    sq = 0.0
    for g0, g1 in zip(jax.tree.leaves(halves[0][1]), jax.tree.leaves(halves[1][1])):
        g = (np.asarray(g0) + np.asarray(g1)) / np.float32(2)
        sq += float(np.sum(g.astype(np.float64) ** 2))
    metrics = {}
    for mb in (2, 1):
        p = from_jax(jax.tree.map(np.asarray, params), "cpu")
        _, state, m = make_train_step(tm, microbatches=mb, base_lr=1e-3, warmup=2,
                                      total_steps=10, remat=False)(p, adamw_init(p), batch)
        metrics[mb] = {k: float(v) for k, v in m.items()}
        assert int(state.step) == 1
    np.testing.assert_allclose(metrics[2]["loss"], want_loss, rtol=1e-6)
    np.testing.assert_allclose(metrics[2]["grad_norm"], sq ** 0.5, rtol=1e-5)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[2][key], metrics[1][key], rtol=1e-5, err_msg=key)


def test_training_after_serving_under_inference_mode():
    """Serving runs under ``torch.inference_mode``; a constant it caches
    (``layers._const``, GELU's) must still serve a later training step in
    the same process."""
    from repro_torch.models import layers
    layers._const.cache_clear()
    with torch.inference_mode():
        layers.gelu(torch.ones(3))
    check_loss_and_grads("chatglm-6b", counted_batch(pair("chatglm-6b")[2].cfg))
