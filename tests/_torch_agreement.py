"""Agreement parity of the ``+w4a8`` variants (the checks of
``tests/test_torch_agreement*.py``): the measured tier of the
reference's ``tests/test_serving_conformance.py::test_w4a8_agreement_floor_vs_lockstep``
(greedy token agreement between continuous serving and per-request
lock-step on the seed-6 trace) on the port, for every variant of its
``W4A8_AGREEMENT_FLOORS``, the two whose floors the reference breaches under
jax 0.9.0 among them.

The rate is deterministic given (trace, seed, params), so the port is held
to the reference's *rate*, not to the pinned floor: the port's continuous
tokens and its lock-step tokens each equal the reference's, request for
request, so the two rates are equal. Same setup as the reference test:
``poisson_trace`` of 4 requests at seed 6 with ``_w4a8_spec``'s prompt and
budget ranges and max_len, 2 slots, chunk 8, decode_ticks 8, lock-step at
batch 1. Both sides serve the reference's quantized leaves of the base
config's PRNGKey(0) init (quantizing is idempotent, so the reference's rate
is that of its own test), so that the clip search's tie-breaks cannot
decide a comparison."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.models.quantized import quantize_params as jax_quantize_params
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine, poisson_trace


def _spec(arch: str) -> dict:
    """``tests/test_serving_conformance.py::_w4a8_spec``."""
    if "+ring" in arch:
        return dict(max_len=256, prompts=(40, 60), gens=(10, 20))
    return dict(max_len=64, prompts=(3, 18), gens=(3, 12))


def _rate(got: dict, want: dict) -> float:
    match = sum(sum(a == b for a, b in zip(got[rid], w)) for rid, w in want.items())
    return match / sum(len(w) for w in want.values())


def _serve(engine_cls, lockstep_cls, model, params, trace, spec, prompt):
    """(continuous tokens by rid, lock-step tokens by rid) of one side."""
    eng = engine_cls(model, params, n_slots=2, max_len=spec["max_len"], chunk=8,
                     decode_ticks=8)
    got = {r["rid"]: list(r["tokens"]) for r in eng.run(trace)["requests"]}
    ref = lockstep_cls(model, params, max_len=spec["max_len"], batch=1)
    want = {r.rid: np.asarray(ref.generate(prompt(r.prompt), steps=r.max_new_tokens))[0].tolist()
            for r in trace}
    return got, want


def check_agreement(arch: str) -> None:
    """The port's continuous and lock-step tokens of ``arch`` each equal the
    reference's, so the agreement rates are equal."""
    spec = _spec(arch)
    jcfg = jax_get_config(arch, reduced=True)
    base = jax_build_model(jax_get_config(arch.replace("+w4a8", ""), reduced=True))
    params = jax_quantize_params(base.init_params(jax.random.PRNGKey(0)))
    kw = dict(n_requests=4, vocab_size=jcfg.vocab_size, prompt_len=spec["prompts"],
              max_new=spec["gens"], seed=6, rate=None)
    jtrace = list(jax_poisson_trace(**kw))
    want_c, want_l = _serve(JaxEngine, JaxServingEngine, jax_build_model(jcfg), params,
                            jtrace, spec, lambda p: jnp.asarray(p)[None])
    trace = list(poisson_trace(**kw))
    assert [list(r.prompt) for r in trace] == [list(r.prompt) for r in jtrace]
    tparams = from_jax(jax.tree.map(np.asarray, params), "cpu")
    with torch.inference_mode():
        got_c, got_l = _serve(ContinuousBatchingEngine, ServingEngine,
                              build_model(get_config(arch, reduced=True), device="cpu"),
                              tparams, trace, spec,
                              lambda p: torch.as_tensor(np.asarray(p))[None])
    assert got_c == want_c, arch
    assert got_l == want_l, arch
    assert _rate(got_c, got_l) == _rate(want_c, want_l), arch
