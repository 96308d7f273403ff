"""The port's lock-step serving path against the reference at reduced size:
parameters converted leaf for leaf, ``prefill`` / ``decode_step`` logits and
caches, and ``ServingEngine.generate`` greedy tokens, for llama2-7b and
qwen3-8b (``decode_impl="kernel"``: on the CPU the port runs its kernels'
plain versions, the reference its Pallas kernels in interpret mode) and
llama2-7b+w4a8 (fed the reference's own quantized leaves, so that the
clip search's tie-breaks cannot decide it).

Tolerances, float32 cases: logits and float caches agree to 1e-4 absolute
(float32 end to end; summation orders differ, nothing else); int8 caches
and their scales exactly (both sides quantize the same float32 values with
the same rounding); greedy tokens exactly.

bfloat16 cases (``compute_dtype="bfloat16"``, the dtype the card serves):
XLA and PyTorch round bf16 intermediates at different points (matmul
outputs, norms, RoPE, residual adds; 2^-8 relative each), so the two sides
differ by a few bf16 steps, compounded over the layers; in the W4A8 case
such a difference now and then moves an int8 activation code, which moves
a projection's output by a code's worth. The limits below are the measured
worst (CPU, this seed) with some room, per config: logits (teacher-forced
on the reference's tokens) within ``atol`` absolute of max |logit| ~4;
caches within ``cache_atol`` as float values (int8 codes times their
scales). Greedy tokens must be equal up to the first step where the
reference's top-2 logit gap is below 2 x ``atol`` (a gap a difference of
``atol`` on each side can close): past that point a flip is a near-tie,
logged in ROADMAP §3, not a failure."""
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

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.models.quantized import quantize_params as jax_quantize_params
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
BATCH, PROMPT, STEPS, MAX_LEN = 3, 12, 10, 64
CASES = [  # config, overrides of its fields
    ("llama2-7b", {"decode_impl": "kernel"}),
    ("qwen3-8b", {"decode_impl": "kernel"}),
    ("llama2-7b+w4a8", {"decode_impl": "kernel"}),
    ("qwen3-8b", {"decode_impl": "blockwise", "rope_mode": "direct"}),
    ("llama2-7b", {"decode_impl": "kernel", "compute_dtype": "bfloat16"}),
    ("llama2-7b+w4a8", {"decode_impl": "kernel", "compute_dtype": "bfloat16"}),
]
# bfloat16 limits by config: (logit atol, cache atol). Measured worst over
# the prefill and two decode steps (CPU, the seeds of this file): llama2-7b
# logits 0.041, caches 0.031 (2 bf16 steps at |K| ~3.5); llama2-7b+w4a8
# logits 0.091, caches 0.095.
BF16_TOLS = {"llama2-7b": (0.0625, 0.0625), "llama2-7b+w4a8": (0.125, 0.125)}


def _numpy_tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "-".join([c[0], *map(str, c[1].values())]))
def run(request):
    """One reference run and one port run of the same config, weights and
    prompts: generate, then prefill + two decode steps by hand."""
    name, overrides = request.param
    jcfg = jax_get_config(name, reduced=True).replace(**overrides)
    tcfg = get_config(name, reduced=True).replace(**overrides)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    params = jm.init_params(jax.random.PRNGKey(0))
    if jcfg.w4a8_serve:
        params = jax_quantize_params(params)
    tparams = from_jax(_numpy_tree(params), "cpu")
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (BATCH, PROMPT))
    prompts = prompts.astype(np.int32)

    out = {"name": name, "atol": ATOL, "cache_atol": ATOL, "margin": 0.0}
    if tcfg.compute_dtype == "bfloat16":
        out["atol"], out["cache_atol"] = BF16_TOLS[name]
        out["margin"] = 2 * out["atol"]
    out["jax_tokens"] = np.asarray(JaxServingEngine(jm, params, max_len=MAX_LEN, batch=BATCH)
                                   .generate(jnp.asarray(prompts), steps=STEPS))
    out["tokens"] = ServingEngine(tm, tparams, max_len=MAX_LEN, batch=BATCH).generate(
        torch.from_numpy(prompts), steps=STEPS).numpy()

    jcache = jm.init_cache(BATCH, MAX_LEN)
    tcache = tm.init_cache(BATCH, MAX_LEN)
    jl, jcache = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jcache)
    with torch.inference_mode():
        tl, tcache = tm.prefill(tparams, torch.from_numpy(prompts), tcache)
    out["logits"] = [(np.asarray(jl, np.float32), tl.float().numpy())]
    out["caches"] = [(jax.tree.map(np.asarray, jcache),
                      {k: v.clone() for k, v in tcache.items()})]
    decode = jax.jit(jm.decode_step)
    prefill_logits = np.asarray(jl, np.float32)
    for _ in range(2):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jcache = decode(params, tok, jcache)
        with torch.inference_mode():
            tl, tcache = tm.decode_step(tparams, torch.from_numpy(np.array(tok)), tcache)
        out["logits"].append((np.asarray(jl, np.float32), tl.float().numpy()))
    out["caches"].append((jax.tree.map(np.asarray, jcache), tcache))
    if out["margin"]:
        # the reference's top-2 logit gap at each greedy step, along its
        # own tokens: step 0 from the prefill, step s from the decode step
        # fed token s - 1
        logits, jcache = prefill_logits, jm.init_cache(BATCH, MAX_LEN)
        _, jcache = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jcache)
        gaps = []
        for step in range(STEPS):
            top = np.sort(logits, axis=-1)
            gaps.append(top[:, -1] - top[:, -2])
            jl, jcache = decode(params, jnp.asarray(out["jax_tokens"][:, step]), jcache)
            logits = np.asarray(jl, np.float32)
        out["gaps"] = np.stack(gaps, axis=1)                    # [BATCH, STEPS]
    return out


def test_generate_greedy_tokens_equal(run):
    """Exactly; in bfloat16, each row up to its first near-tie step."""
    if not run["margin"]:
        np.testing.assert_array_equal(run["tokens"], run["jax_tokens"])
        return
    for row, gaps in enumerate(run["gaps"]):
        near = np.flatnonzero(gaps < run["margin"])
        upto = near[0] if near.size else STEPS
        np.testing.assert_array_equal(run["tokens"][row, :upto], run["jax_tokens"][row, :upto],
                                      err_msg=f"row {row}, before its first near-tie")


def test_prefill_and_decode_logits(run):
    for i, (want, got) in enumerate(run["logits"]):
        np.testing.assert_allclose(got, want, atol=run["atol"], err_msg=f"step {i}")


def _dequantized(cache, key, to_np):
    """An int8 cache plane [L, B, S, Hkv, Dh] times its scales [L, B, Hkv, S]."""
    scale = np.swapaxes(to_np(cache[key + "_scale"]), 2, 3)[..., None]
    return to_np(cache[key]) * scale


def test_caches_after_prefill_and_decode(run):
    tol = run["cache_atol"]
    for want, got in run["caches"]:
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            assert tuple(g.shape) == w.shape, key
            if run["margin"] and key in ("k", "v"):                # bfloat16 cases
                if g.dtype == torch.int8:
                    w = _dequantized(want, key, lambda a: np.asarray(a, np.float32))
                    g = _dequantized(got, key, lambda t: t.float().numpy())
                    np.testing.assert_allclose(g, w, atol=tol, err_msg=key)
                else:
                    np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                               atol=tol, err_msg=key)
            elif run["margin"] and key.endswith("_scale"):
                continue                        # held through the dequantized planes
            elif g.dtype == torch.int8 or key == "len":
                np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
            elif g.dtype == torch.bfloat16:                 # int8 scale planes
                np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=key)


_BF16_EXACT = """
import json
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import get_config as jgc
from repro.models.api import build_model as jbm
from repro.models.quantized import quantize_params as jqp
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models.api import build_model
from repro_torch.serving import ServingEngine
name, over = "llama2-7b+w4a8", {"decode_impl": "kernel", "compute_dtype": "bfloat16"}
jm = jbm(jgc(name, reduced=True).replace(**over))
tm = build_model(get_config(name, reduced=True).replace(**over), device="cpu")
params = jax.jit(lambda key: jqp(jm.init_params(key)))(jax.random.PRNGKey(0))
tp = from_jax(jax.tree.map(np.asarray, params), "cpu")
prompts = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (3, 12)).astype(np.int32)
tt = ServingEngine(tm, tp, max_len=64, batch=3).generate(torch.from_numpy(prompts), steps=10)
# the reference's greedy loop (ServingEngine.generate's), each step's logits
# beside the port's on the reference's tokens
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
print(json.dumps({"jax": np.asarray(jt).T.tolist(), "port": tt.tolist(), "diffs": diffs}))
"""


def test_bf16_w4a8_equals_the_reference_program_bitwise():
    """The W4A8 bf16 case of CASES, against the reference compiled with
    ``--xla_allow_excess_precision=false``: XLA then rounds every bf16 op
    where the reference's program rounds, and the port matches it bit for
    bit — prefill and 10 decode-step logits (teacher-forced on the
    reference's tokens) exactly equal, greedy tokens equal over all 10
    steps. Under XLA's default (excess precision allowed) XLA skips some of
    those roundings inside its fusions (the residual sum feeding rms_norm,
    silu(g) * u before quantize_a8), which is the case's near-tie flip at
    row 1, step 7 (ROADMAP §3, "not faults")."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    res = subprocess.run([sys.executable, "-c", _BF16_EXACT], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["diffs"] == [0.0] * 11
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("name", ["qwen3-8b", "llama2-7b+w4a8", "h2o-danube-1.8b+ring+w4a8"])
def test_from_jax_leaf_for_leaf(name):
    cfg = jax_get_config(name, reduced=True)
    params = jax_build_model(cfg).init_params(jax.random.PRNGKey(3))
    if cfg.w4a8_serve:
        params = jax_quantize_params(params)
    want = dict(_flat(_numpy_tree(params)))
    got = dict(_flat(from_jax(_numpy_tree(params), "cpu")))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == w.dtype.name, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
    # dtype= casts the float weights, never the int4 codes or group scales
    cast = dict(_flat(from_jax(_numpy_tree(params), "cpu", dtype=torch.bfloat16)))
    for key, t in cast.items():
        if key.endswith("__qp"):
            assert t.dtype == torch.uint8, key
        elif key.endswith("__qs"):
            assert t.dtype == torch.float32, key
        else:
            assert t.dtype == torch.bfloat16, key


def test_sampled_generate_replays():
    """Sampling draws from a ``prng`` key: the same key replays the same
    tokens, another key draws others (the tokens equal the reference's:
    ``tests/test_torch_families.py::test_sampled_generate_matches_reference``)."""
    from repro_torch.core import prng
    cfg = get_config("qwen3-8b", reduced=True)
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, model.init_params(0), max_len=32, batch=2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(0))
    runs = [eng.generate(prompts, steps=8, temperature=0.8, rng=prng.prng_key(s))
            for s in (7, 7, 8)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert runs[0].shape == (2, 8)
    assert not torch.equal(runs[0], runs[2])


def test_eos_retires_rows_like_the_reference():
    """A row that emits eos keeps emitting pad_id afterwards, as in the
    reference engine (the eos id is the row's own first token)."""
    cfg = get_config("llama2-7b", reduced=True)
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, model.init_params(0), max_len=32, batch=2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    free = eng.generate(prompts, steps=6)
    eos = int(free[0, 1])
    out = eng.generate(prompts, steps=6, eos_id=eos, pad_id=-1)
    first = int((free[0] == eos).nonzero()[0])
    assert (out[0, : first + 1] == free[0, : first + 1]).all()
    assert (out[0, first + 1:] == -1).all()


# the continuous path's and MoE modules, which must be among those walked
NEW_MODULES = ["serving.continuous", "serving.scheduler", "serving.slot_pool",
               "serving.workload", "serving.telemetry", "core.prng", "models.moe",
               "models.rwkv6", "models.mamba", "serving.trace", "serving.faults",
               "serving.audit", "tree", "optim.adamw", "data.pipeline",
               "checkpoint.manager", "train.step", "train.loop", "launch.train",
               "distributed.context", "distributed.sharding", "distributed.sp_attention",
               "launch.mesh", "distributed.roofline", "launch.dryrun", "configs",
               "core.quantization", "models.quantized", "kernels.gemv_w4a8.ops",
               "paper.edge_cost_model", "paper.paper_figures", "paper.roofline_table",
               "paper.run"]
# the port's counterparts of the reference's public functions, by module
PUBLIC = {"configs": "all_configs", "core.quantization": "dequantize_w4",
          "models.quantized": "quantized_bytes", "kernels.gemv_w4a8.ops": "linear_w4a8"}


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of the port (the continuous path's among
    them) and every example of the port (``examples/torch_*.py``) pulls in
    neither jax nor repro."""
    examples = sorted(str(p) for p in (ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 5
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for i, path in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'_example_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"missing = [m for m in {NEW_MODULES!r} if 'repro_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        f"for m, name in {PUBLIC!r}.items():\n"
        "    assert callable(getattr(sys.modules['repro_torch.' + m], name)), (m, name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_entry_points_without_device_raise(monkeypatch):
    """No GPU and no device given: the entry points raise; there is no
    silent fallback to the CPU."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.paper import run as paper_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama2-7b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--reduced", "--continuous"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_run.main(["--skip-slow"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    out, metrics = serve.main(["--arch", "qwen3-8b+w4a8", "--reduced", "--device", "cpu",
                               "--decode-impl", "kernel", "--batch", "2",
                               "--prompt-len", "8", "--gen", "4"])
    assert out.shape == (2, 4) and metrics["device"] == "cpu"
    assert '"tokens_per_s"' in capsys.readouterr().out
    report, metrics = serve.main(["--arch", "llama2-7b", "--reduced", "--device", "cpu",
                                  "--continuous", "--requests", "2", "--n-slots", "2",
                                  "--max-len", "32", "--chunk", "8", "--prompt-len", "8",
                                  "--gen", "4"])
    assert metrics["mode"] == "continuous" and metrics["n_retired"] == 2
    assert '"host_syncs"' in capsys.readouterr().out


@pytest.mark.parametrize("decode_impl", ["kernel", "blockwise"])
def test_w4a8_projections_take_the_gemv_wrapper_whatever_decode_impl(decode_impl,
                                                                      monkeypatch):
    """Every W4A8 projection of prefill and decode goes through the GEMV
    kernel's wrapper (which chooses kernel or plain version by device);
    ``decode_impl`` chooses the decode attention only."""
    from repro_torch.kernels.gemv_w4a8 import ops as gemv_ops
    from repro_torch.models.quantized import quantize_params
    calls = []
    wrapper = gemv_ops.gemv_w4a8
    monkeypatch.setattr(gemv_ops, "gemv_w4a8",
                        lambda *a, **kw: calls.append(1) or wrapper(*a, **kw))
    cfg = get_config("llama2-7b+w4a8", reduced=True).replace(decode_impl=decode_impl)
    model = build_model(cfg, device="cpu")
    params = quantize_params(model.init_params(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(2))
    out = ServingEngine(model, params, max_len=16, batch=2).generate(prompts, steps=3)
    assert out.shape == (2, 3)
    assert len(calls) == 7 * cfg.n_layers * (1 + 3)     # prefill + 3 decode steps


def test_unported_families_raise():
    cfg = get_config("llama2-7b", reduced=True)
    # the audio family is ported (models/whisper.py); a family the reference
    # lacks still raises
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg.replace(family="diffusion"), device="cpu")
    # every decode_impl of the reference is ported (sp since the distribution
    # layer's serving half); one the reference lacks still raises
    with pytest.raises(NotImplementedError, match="not one of"):
        build_model(cfg.replace(decode_impl="flash"), device="cpu")
