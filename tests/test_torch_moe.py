"""The port's MoE (``repro_torch.models.moe`` and the ``family="moe"``
branches of ``TransformerLM``) against the reference at reduced size.

Functions, float32, the same numpy inputs on both sides: ``moe_apply``
(capacity dispatch) within 1e-5 absolute, also where the capacity drops
assignments, and then the kept (token, expert) set exactly equal;
``moe_apply_rowwise`` and ``moe_apply_dense_ref`` within 1e-5; the
load-balance loss within 1e-6; the router's top-k exactly equal, ties
broken to the lower expert index as ``lax.top_k`` does.

Models, float32, the reference's weights converted leaf for leaf:
olmoe-1b-7b (64 experts top-8 at full width, qk-norm; 8 top-2 reduced) and
llama4-scout (16 experts top-1; 4 reduced), lock-step logits and caches
within 1e-4 and greedy tokens exactly, continuous tokens exactly at
decode_ticks 1 and 4; ``+w4a8`` quantizes the attention projections and
leaves the 4-D expert stacks dense, as the reference's ``_eligible`` does.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (BATCH, MAX_LEN, PROMPT, STEPS, check_engine, check_lockstep,
                           flat, pair)
from repro.models import moe as jax_moe
from repro.models.quantized import quantize_params as jax_quantize_params
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.convert import from_jax
from repro_torch.models import moe
from repro_torch.models.quantized import quantize_params
from repro_torch.serving import ServingEngine

MOE = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
ATOL = 1e-5


def experts(seed, d=32, f=48, e=8, gated=True, tie=False):
    """Random expert weights as numpy arrays; ``tie`` copies expert 0's
    router column into expert 5's, so every token's probabilities tie."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    p = {"router": draw(d, e), "up": draw(e, d, f), "down": draw(e, f, d)}
    if gated:
        p["gate"] = draw(e, d, f)
    if tie:
        p["router"][:, 5] = p["router"][:, 0]
    x = rng.standard_normal((3, 10, d)).astype(np.float32)
    return p, x


def both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))


def kept(mod, top_e, e, c):
    """The set of (flat pair, expert) that fit the capacity."""
    flat_e, _, keep = mod._queue_positions(top_e, e, c)
    keep, flat_e = np.asarray(keep), np.asarray(flat_e)
    return {(int(i), int(flat_e[i])) for i in np.flatnonzero(keep)}


# (seed, top_k, act, gated, capacity_factor, capacity, tie)
CASES = [(0, 2, "silu", True, 1.25, None, False),
         (1, 1, "silu", True, 1.25, None, False),
         (2, 2, "gelu", False, 8.0, None, False),
         (3, 4, "silu", True, 0.5, None, False),        # drops assignments
         (4, 2, "silu", True, None, 10, False),         # chunk-style capacity = C
         (5, 3, "silu", True, 1.0, None, True)]         # ties in every row


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}-k{c[1]}")
def test_moe_apply_matches_reference(case):
    seed, k, act, gated, cf, cap, tie = case
    p, x = experts(seed, gated=gated, tie=tie)
    jp, jx, tp, tx = both(p, x)
    kw = dict(top_k=k, act=act, gated=gated)
    ckw = {"capacity": cap} if cap else {"capacity_factor": cf}
    jy, jaux = jax_moe.moe_apply(jp, jx, **kw, **ckw)
    ty, taux = moe.moe_apply(tp, tx, **kw, **ckw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    # the router's choice and the capacity's cut, exactly
    je, jw, _ = jax_moe._route(jx.reshape(-1, x.shape[-1]), jp["router"], k)
    te, tw, _ = moe._route(tx.reshape(-1, x.shape[-1]), tp["router"], k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    e, t = p["router"].shape[1], x.shape[0] * x.shape[1]
    c = cap or max(int(t * k / e * cf), 8)
    jkept, tkept = kept(jax_moe, je, e, c), kept(moe, te, e, c)
    assert tkept == jkept
    if cf == 0.5:
        assert len(tkept) < t * k, "this case must drop assignments"
    if tie:             # the tied pair is chosen together somewhere, 0 first
        together = ((te == 0).any(-1) & (te == 5).any(-1)).nonzero()[:, 0]
        assert len(together)
        for row in te[together].tolist():
            assert row.index(0) < row.index(5)


@pytest.mark.parametrize("case", CASES[:3] + CASES[5:], ids=lambda c: f"seed{c[0]}-k{c[1]}")
def test_rowwise_and_dense_ref_match_reference(case):
    seed, k, act, gated, _, _, tie = case
    p, x = experts(seed, gated=gated, tie=tie)
    jp, jx, tp, tx = both(p, x)
    kw = dict(top_k=k, act=act, gated=gated)
    jy, jaux = jax_moe.moe_apply_rowwise(jp, jx.reshape(-1, x.shape[-1]), **kw)
    ty, taux = moe.moe_apply_rowwise(tp, tx.reshape(-1, x.shape[-1]), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    dense = moe.moe_apply_dense_ref(tp, tx, **kw)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax_moe.moe_apply_dense_ref(
        jp, jx, **kw)), atol=ATOL)
    # nothing drops at capacity factor 8: all three forms agree
    np.testing.assert_allclose(ty.numpy().reshape(x.shape), dense.numpy(), atol=ATOL)


def test_rowwise_rows_are_independent():
    """A row's output does not depend on the other rows of the batch."""
    p, x = experts(6)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xf = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    full, _ = moe.moe_apply_rowwise(tp, xf, top_k=2)
    for i in (0, 7, 29):
        alone, _ = moe.moe_apply_rowwise(tp, xf[i:i + 1], top_k=2)
        torch.testing.assert_close(alone[0], full[i], rtol=0, atol=0)


def test_expert_parallel_form_raises():
    """The expert-parallel form is chosen by the distribution context (as
    in the reference), not by an argument: ``ep_group=`` is gone and raises;
    without a context ``moe_apply`` is the single-process dispatch (the
    form itself: ``tests/test_torch_dist_world.py``)."""
    from repro_torch.distributed.context import get_context
    p, x = experts(0)
    tp, tx = {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)
    with pytest.raises(TypeError, match="ep_group"):
        moe.moe_apply(tp, tx, top_k=2, ep_group=object())
    assert not get_context().active
    y, aux = moe.moe_apply(tp, tx, top_k=2)
    t = tx.shape[0] * tx.shape[1]
    top_e, top_w, want_aux = moe._route(tx.reshape(t, -1), tp["router"], 2)
    want = moe._dispatch_ffn_combine(tp, tx.reshape(t, -1), top_e, top_w, top_k=2,
                                     c=moe.capacity_for(t, 2, tp["router"].shape[-1], 1.25),
                                     act="silu", gated=True)
    torch.testing.assert_close(y.reshape(t, -1), want, rtol=0, atol=0)
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)


@pytest.mark.parametrize("name", MOE)
def test_lockstep_logits_caches_and_tokens(name):
    check_lockstep(name)


@pytest.mark.parametrize("ticks", [1, 4])
@pytest.mark.parametrize("name", MOE)
def test_continuous_tokens_match_reference_engine(name, ticks):
    check_engine(name, ticks)


def test_init_params_layout():
    """The port's own random init has the reference's tree and shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    jm, params, _, _ = pair("olmoe-1b-7b")
    want = {k: v.shape for k, v in flat(jax.tree.map(np.asarray, params))}
    tm = build_model(get_config("olmoe-1b-7b", reduced=True), device="cpu")
    got = {k: tuple(v.shape) for k, v in flat(tm.init_params(0))}
    assert got == want
    assert got["blocks/ffn/up"] == (2, 8, 64, 32) and got["blocks/ffn/router"] == (2, 64, 8)


@pytest.mark.parametrize("name", MOE)
def test_w4a8_keeps_expert_stacks_dense(name):
    """``+w4a8``: the port's ``quantize_params`` makes the reference's tree
    (attention int4-packed, router and the 4-D expert stacks dense, bit for
    bit the same leaves), and lock-step serving on the reference's
    quantized leaves gives the reference's greedy tokens."""
    jm, params, tm, tparams = pair(name + "+w4a8")
    jq = dict(flat(jax.tree.map(np.asarray, jax_quantize_params(params))))
    tq = dict(flat(quantize_params(tparams)))
    assert tq.keys() == jq.keys()
    ffn = {k for k in tq if k.startswith("blocks/ffn/")}
    assert ffn == {f"blocks/ffn/{n}" for n in ("router", "up", "gate", "down")}
    assert all(tq[k].ndim == 4 for k in ffn - {"blocks/ffn/router"})
    assert {"blocks/attn/wq__qp", "blocks/attn/wo__qs"} <= tq.keys()
    for k in ffn:
        np.testing.assert_array_equal(tq[k].numpy(), jq[k], err_msg=k)
    # the engines quantize their params; already-quantized leaves pass
    # through, so both serve the reference's own leaves
    jparams = jax_quantize_params(params)
    prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (BATCH, PROMPT))
    prompts = prompts.astype(np.int32)
    want = JaxServingEngine(jm, jparams, max_len=MAX_LEN, batch=BATCH).generate(
        jnp.asarray(prompts), steps=STEPS)
    got = ServingEngine(tm, from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
                        max_len=MAX_LEN, batch=BATCH).generate(torch.from_numpy(prompts),
                                                               steps=STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
