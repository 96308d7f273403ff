"""The port's lock-step serving path against the reference at reduced size:
parameters converted leaf for leaf, ``prefill`` / ``decode_step`` logits and
caches, and ``ServingEngine.generate`` greedy tokens, for llama2-7b and
qwen3-8b (``decode_impl="kernel"``: on the CPU the port runs its kernels'
plain versions, the reference its Pallas kernels in interpret mode) and
llama2-7b+w4a8 (fed the reference's own quantized leaves, so that the
clip search's tie-breaks cannot decide it).

Tolerances: logits and float caches agree to 1e-4 absolute (float32 end to
end; summation orders differ, nothing else); int8 caches and their scales
exactly (both sides quantize the same float32 values with the same
rounding); greedy tokens exactly."""
from __future__ import annotations

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
]


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

    out = {"name": name}
    out["jax_tokens"] = np.asarray(JaxServingEngine(jm, params, max_len=MAX_LEN, batch=BATCH)
                                   .generate(jnp.asarray(prompts), steps=STEPS))
    out["tokens"] = ServingEngine(tm, tparams, max_len=MAX_LEN, batch=BATCH).generate(
        torch.from_numpy(prompts), steps=STEPS).numpy()

    jcache = jm.init_cache(BATCH, MAX_LEN)
    tcache = tm.init_cache(BATCH, MAX_LEN)
    jl, jcache = jax.jit(jm.prefill)(params, jnp.asarray(prompts), jcache)
    with torch.inference_mode():
        tl, tcache = tm.prefill(tparams, torch.from_numpy(prompts), tcache)
    out["logits"] = [(np.asarray(jl), tl.numpy())]
    out["caches"] = [(jax.tree.map(np.asarray, jcache),
                      {k: v.clone() for k, v in tcache.items()})]
    decode = jax.jit(jm.decode_step)
    for _ in range(2):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl, jcache = decode(params, tok, jcache)
        with torch.inference_mode():
            tl, tcache = tm.decode_step(tparams, torch.from_numpy(np.array(tok)), tcache)
        out["logits"].append((np.asarray(jl), tl.numpy()))
    out["caches"].append((jax.tree.map(np.asarray, jcache), tcache))
    return out


def test_generate_greedy_tokens_equal(run):
    np.testing.assert_array_equal(run["tokens"], run["jax_tokens"])


def test_prefill_and_decode_logits(run):
    for i, (want, got) in enumerate(run["logits"]):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"step {i}")


def test_caches_after_prefill_and_decode(run):
    for want, got in run["caches"]:
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            assert tuple(g.shape) == w.shape, key
            if g.dtype == torch.int8 or key == "len":
                np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
            elif g.dtype == torch.bfloat16:                 # int8 scale planes
                np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", ["qwen3-8b", "llama2-7b+w4a8"])
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
    """Sampling draws from a seeded generator: the same seed replays the
    same tokens (the reference's jax.random stream is not matched)."""
    cfg = get_config("qwen3-8b", reduced=True)
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, model.init_params(0), max_len=32, batch=2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(0))
    runs = [eng.generate(prompts, steps=8, temperature=0.8,
                         generator=torch.Generator().manual_seed(s)) for s in (7, 7)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert runs[0].shape == (2, 8)


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


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of the port pulls in neither jax nor repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama2-7b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--reduced"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    out, metrics = serve.main(["--arch", "qwen3-8b+w4a8", "--reduced", "--device", "cpu",
                               "--decode-impl", "kernel", "--batch", "2",
                               "--prompt-len", "8", "--gen", "4"])
    assert out.shape == (2, 4) and metrics["device"] == "cpu"
    assert '"tokens_per_s"' in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not ported"):
        serve.main(["--arch", "llama2-7b", "--reduced", "--device", "cpu", "--continuous"])


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
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg.replace(family="moe"), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg.replace(decode_impl="tokenwise"), device="cpu")
