"""The port's remaining dense configs (chatglm-6b: partial rotary and a plain
GELU MLP; gemma-2b: MQA, GeGLU, tied embeddings; mistral-nemo-12b: a head
dim that is not d_model / n_heads) against the reference at reduced size,
and the lock-step engine's sampled tokens against the reference's.

float32, ``decode_impl="kernel"`` (the port runs its kernels' plain versions
on the CPU, the reference its Pallas kernels in interpret mode), the
reference's weights converted leaf for leaf: ``prefill`` / ``decode_step``
logits and caches within 1e-4 absolute (float32 end to end; summation
orders differ, nothing else); the ragged forms (``prefill_chunk``,
``prefill_chunks_batched``, ``finalize_slot``, ``decode_step(active=)``,
``decode_multi``, ``release_slot``) the same; greedy lock-step and
continuous tokens exactly.

chatglm-6b in bf16 is held bit for bit to the reference compiled with
``--xla_allow_excess_precision=false`` (in a subprocess), and so is the
port's GELU on every finite bf16 input whose result XLA does not flush to
zero (XLA's CPU code flushes denormals; the port's does not).

Sampling: ``ServingEngine.generate`` at temperature 0.8 with the default
key draws the reference's tokens (llama2-7b, MHA, and qwen3-8b, GQA with
qk-norm)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (BATCH, MAX_LEN, PROMPT, STEPS, check_engine, check_lockstep,
                           check_ragged, flat, pair)
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["chatglm-6b", "gemma-2b", "mistral-nemo-12b"]

@pytest.mark.parametrize("name", DENSE)
def test_from_jax_leaf_for_leaf(name):
    _, params, _, tparams = pair(name)
    want = dict(flat(jax.tree.map(np.asarray, params)))
    got = dict(flat(tparams))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert str(got[key].dtype).removeprefix("torch.") == w.dtype.name, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)


@pytest.mark.parametrize("name", DENSE)
def test_lockstep_logits_caches_and_tokens(name):
    check_lockstep(name)


@pytest.mark.parametrize("name", DENSE)
def test_ragged_model_functions_match_reference(name):
    check_ragged(name)


@pytest.mark.parametrize("name", DENSE)
def test_continuous_tokens_match_reference_engine(name):
    check_engine(name, ticks=4)


def test_config_fields_reach_the_model():
    """What these configs set and the earlier ones did not: partial rotary
    (chatglm-6b rotates 8 of 16 dims at reduced size, 64 of 128 at full),
    tied embeddings (gemma-2b: no unembed leaf) and a head dim that is not
    d_model / n_heads (mistral-nemo-12b at full width: 128 vs 160)."""
    chatglm, gemma = get_config("chatglm-6b"), get_config("gemma-2b", reduced=True)
    assert chatglm.rotary_dim == 64 and get_config("chatglm-6b", reduced=True).rotary_dim == 8
    tm = build_model(get_config("chatglm-6b", reduced=True), device="cpu")
    assert tm.init_cache(1, 8)["rope_cos"].shape == (1, 4)
    assert "unembed" not in build_model(gemma, device="cpu").init_params(0)
    nemo = get_config("mistral-nemo-12b")
    assert nemo.resolved_head_dim * nemo.n_heads == 4096 != nemo.d_model


_BF16_EXACT = """
import json
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import get_config as jgc
from repro.models.api import build_model as jbm
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model
from repro_torch.models.layers import gelu
from repro_torch.serving import ServingEngine
# GELU on every finite bf16 input
bits = np.arange(65536, dtype=np.uint16).view(np.int16).copy()
x = torch.from_numpy(bits).view(torch.bfloat16)
x = x[torch.isfinite(x)]
want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x.float().numpy(), jnp.bfloat16))
                  .astype(jnp.float32))
got = gelu(x).float().numpy()
differ = want != got
flushed = differ & (want == 0) & (np.abs(got) <= np.finfo(np.float32).tiny)
gelu_out = {"inputs": int(x.numel()), "differ": int(differ.sum()),
            "flushed_by_xla": int(flushed.sum())}
name, over = "chatglm-6b", {"decode_impl": "kernel", "compute_dtype": "bfloat16"}
jm = jbm(jgc(name, reduced=True).replace(**over))
tm = build_model(get_config(name, reduced=True).replace(**over), device="cpu")
params = jm.init_params(jax.random.PRNGKey(0))
tp = from_jax(jax.tree.map(np.asarray, params), "cpu")
prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (3, 12)).astype(np.int32)
tt = ServingEngine(tm, tp, max_len=64, batch=3).generate(torch.from_numpy(prompts), steps=10)
jc, tc = jm.init_cache(3, 64), tm.init_cache(3, 64)
jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jc)
with torch.inference_mode():
    tl, tc = tm.prefill(tp, torch.from_numpy(prompts), tc)
diffs, jt = [float(np.abs(np.asarray(jl, np.float32) - tl.numpy()).max())], []
decode = jax.jit(jm.decode_step)
for step in range(10):
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    jt.append(np.asarray(tok).tolist())
    jl, jc = decode(params, tok, jc)
    with torch.inference_mode():
        tl, tc = tm.decode_step(tp, torch.from_numpy(np.asarray(tok)), tc)
    diffs.append(float(np.abs(np.asarray(jl, np.float32) - tl.numpy()).max()))
cache_equal = all(np.array_equal(np.asarray(jc[k], np.float32), tc[k].float().numpy())
                  for k in ("k", "v"))
print(json.dumps({"jax": np.asarray(jt).T.tolist(), "port": tt.tolist(), "diffs": diffs,
                  "cache_equal": cache_equal, "gelu": gelu_out}))
"""


def test_chatglm_bf16_equals_the_reference_program_bitwise():
    """chatglm-6b (plain GELU MLP, partial rotary) in bf16 against the
    reference compiled with ``--xla_allow_excess_precision=false``: the
    prefill's and 10 decode steps' logits (teacher-forced on the
    reference's tokens) and the caches exactly equal, greedy tokens equal.
    The port's GELU equals ``jax.nn.gelu`` on every finite bf16 input
    whose result is a normal number; where XLA flushes a denormal result to
    zero, the port keeps it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    res = subprocess.run([sys.executable, "-c", _BF16_EXACT], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    g = out["gelu"]
    assert g["inputs"] == 65280 and g["differ"] == g["flushed_by_xla"] < 600, g
    assert out["diffs"] == [0.0] * 11
    assert out["cache_equal"]
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("name", ["llama2-7b", "qwen3-8b"])
def test_sampled_generate_matches_reference(name):
    """temperature 0.8, the default key (the reference's PRNGKey(0)): the
    first token drawn with the key, each later one with the second half of
    its split, ``categorical`` as Gumbel-max on f32 logits."""
    jm, params, tm, tparams = pair(name)
    prompts = np.random.default_rng(4).integers(0, jm.cfg.vocab_size, (BATCH, PROMPT))
    prompts = prompts.astype(np.int32)
    want = np.asarray(JaxServingEngine(jm, params, max_len=MAX_LEN, batch=BATCH).generate(
        jnp.asarray(prompts), steps=STEPS, temperature=0.8))
    greedy = np.asarray(JaxServingEngine(jm, params, max_len=MAX_LEN, batch=BATCH).generate(
        jnp.asarray(prompts), steps=STEPS))
    assert (want != greedy).any(), "sampling must move some token"
    got = ServingEngine(tm, tparams, max_len=MAX_LEN, batch=BATCH).generate(
        torch.from_numpy(prompts), steps=STEPS, temperature=0.8)
    np.testing.assert_array_equal(got.numpy(), want)
