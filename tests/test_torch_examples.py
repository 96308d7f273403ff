"""The port's serving examples (``examples/torch_*.py``) on the CPU
(``--device cpu``), each held against the reference:

* quickstart: the reference's ``examples/quickstart.py`` ``main()`` (loaded
  by path, its kernel in interpret mode) and the port's, both printed: the
  LUT and Q15.17 lines equal as printed (the LUT error is the same table,
  the Q15.17 datapath the same integers); each of the port's four errors
  against the two-pass oracle at most 1e-5;
* serve_decode (``--gen 8``): on the reference's ``init_params(PRNGKey(0))``
  (converted) and its prompts, every decode impl's greedy tokens, and both
  RoPE modes', equal the reference ``ServingEngine.generate``'s;
* serve_continuous: on the reference's converted llama2-7b tree and the
  same trace, every request's tokens and the aggregate's ``n_retired``,
  ``generated_tokens`` and ``host_syncs`` equal the reference engine's;
* with no GPU and no ``--device``, every example's ``main`` raises.

The training examples are held in ``tests/test_torch_examples_train.py``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxContinuousEngine
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch.convert import from_jax

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("torch_quickstart", "torch_serve_decode", "torch_serve_continuous",
            "torch_train_lm", "torch_multi_arch_smoke")
ERR_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tree(name: str) -> tuple:
    """The reference's reduced ``name`` and its ``init_params(PRNGKey(0))``
    as numpy arrays."""
    jm = jax_build_model(jax_get_config(name, reduced=True))
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


def _lines(text: str, prefix: str) -> list[str]:
    return [line for line in text.splitlines() if line.startswith(prefix)]


def test_quickstart_against_the_reference(capsys):
    load_example("quickstart").main()                      # the reference's
    want = capsys.readouterr().out
    got = load_example("torch_quickstart").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    for prefix in ("LUT exp max rel err", "Q15.17 fixed-point attention"):
        assert _lines(printed, prefix) == _lines(want, prefix) != [], prefix
    for name in ("tokenwise", "blockwise", "kernel", "merged"):
        assert 0 <= got[name] <= ERR_TOL, (name, got[name])
    assert len(printed.splitlines()) == len(want.splitlines()) == 6


def test_serve_decode_against_the_reference():
    jm, tree = _jax_tree("gemma-2b")
    prompts = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, jm.cfg.vocab_size)
    want = np.asarray(JaxServingEngine(jm, tree, max_len=64, batch=4).generate(prompts,
                                                                               steps=8))
    got = load_example("torch_serve_decode").run(
        "cpu", gen=8, params=from_jax(tree, "cpu"), prompts=np.array(prompts))
    assert set(got["tokens"]) == {"blockwise", "tokenwise", "kernel", "naive",
                                  "incremental", "direct"}
    for impl, toks in got["tokens"].items():
        np.testing.assert_array_equal(toks, want, err_msg=impl)
    assert got["rope_same"] and all(v == 0 for v in got["launches"].values())


def test_serve_continuous_against_the_reference():
    jm, tree = _jax_tree("llama2-7b")
    trace = jax_poisson_trace(n_requests=8, vocab_size=jm.cfg.vocab_size,
                              prompt_len=(4, 24), max_new=(3, 16), seed=7)
    eng = JaxContinuousEngine(jm, tree, n_slots=3, max_len=64, chunk=8, decode_ticks=4)
    eng.warmup()
    want = eng.run(trace)
    got = load_example("torch_serve_continuous").run("cpu", params=from_jax(tree, "cpu"))
    assert got["same"]
    assert got["tokens"] == {r["rid"]: list(r["tokens"]) for r in want["requests"]}
    for key in ("n_retired", "generated_tokens", "host_syncs"):
        assert got["aggregate"][key] == want["aggregate"][key], key


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_without_a_device_raise(monkeypatch, name):
    """No GPU and no ``--device``: ``main`` raises (no fallback to the
    CPU), before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(name).main([])
