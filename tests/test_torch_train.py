"""The port's training substrate against the reference's: the ``core/prng.py``
additions (``split``, ``uniform``, ``categorical``, ``normal``) against
``jax.random``; ``data/pipeline.py`` (tokens and labels bit for bit);
``optim/adamw.py`` (the schedule, the update and its clipping on the same
numpy inputs); ``checkpoint/manager.py`` (round trip, keep-last-k, CRC,
atomic rename, the reference's array keys, checkpoints read across the two
packages); ``train/loop.py`` (checkpoints, retry after an injected failure,
deterministic resume, and its losses beside the reference's ``TrainLoop``
from the same parameters); and ``launch/train.py`` on the CPU.

Tolerances. ``normal`` in float32 within 4 ulp (XLA's CPU ``log1p`` and
its FMA-contracted polynomial round differently from PyTorch's); in
bfloat16 bitwise. AdamW: ``lr`` within 1e-6 relative (``cos``), the
parameters within 1e-6 of the leaf's largest value, the moments likewise
(XLA contracts ``b1 * m + (1 - b1) * g`` into an FMA: ulps apart, up to 32
where the two terms cancel). The loop's losses within 1e-5 relative of the
reference's."""
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

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import batch_for_step as jax_batch_for_step
from repro.data.pipeline import source_for_step as jax_source_for_step
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.train import TrainLoop as JaxTrainLoop
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core import prng
from repro_torch.data.pipeline import batch_for_step, source_for_step
from repro_torch.launch import train as train_cli
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.train import TrainLoop, make_train_step
from repro_torch.tree import tree_items

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# core/prng.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("num", [2, 5])
def test_split_matches_reference(seed, num):
    """``split(key)[i]`` is ``fold_in(key, i)``: the pair the port's sampled
    serving derives from a key is the reference's ``split``."""
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)).astype(np.int64)
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(prng.split(key, num).numpy(), want)
    for i in range(num):
        np.testing.assert_array_equal(prng.fold_in(key, i).numpy(), want[i])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (-1.0, 1.0), (0.25, 3.5)])
def test_uniform_matches_reference(dtype, minval, maxval):
    want = jax.random.uniform(jax.random.PRNGKey(3), (4, 1000), jnp.dtype(dtype), minval,
                              maxval)
    got = prng.uniform(prng.prng_key(3), (4, 1000), getattr(torch, dtype), minval, maxval)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("shape", [(3, 17), (2, 5, 9)])
@pytest.mark.parametrize("piece", [503, 1 << 25])     # a row at a time, or all at once
def test_categorical_matches_reference(shape, piece, monkeypatch):
    monkeypatch.setattr(prng, "_PIECE", piece)
    logits = -1.1 * jnp.log(jnp.arange(1, 504, dtype=jnp.float32))
    want = jax.random.categorical(jax.random.PRNGKey(11), logits, shape=shape)
    got = prng.categorical(prng.prng_key(11), torch.from_numpy(np.array(logits)), shape)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normal_matches_reference(dtype):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (64, 1024), jnp.dtype(dtype)),
                      np.float32)
    got = prng.normal(prng.prng_key(5), (64, 1024), getattr(torch, dtype)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=4)


# ---------------------------------------------------------------------------
# data/pipeline.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq_len,batch,seed,step",
                         [(503, 16, 2, 0, 0), (503, 33, 3, 7, 5), (1000, 32, 4, 0, 7),
                          (32000, 64, 2, 0, 3)])
def test_batch_for_step_bitwise(vocab, seq_len, batch, seed, step):
    want = jax_batch_for_step(vocab, seq_len, batch, seed, step)
    got = batch_for_step(vocab, seq_len, batch, seed, step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and tuple(got[k].shape) == (batch, seq_len)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_batch_is_counted_and_causal():
    a = batch_for_step(1000, 32, 4, 0, 7)
    b = batch_for_step(1000, 32, 4, 0, 7)
    c = batch_for_step(1000, 32, 4, 0, 8)
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < 1000 and int(a["tokens"].min()) >= 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["whisper-small", "llama-3.2-vision-90b"])
def test_source_for_step_matches_reference(name, dtype):
    jcfg = jax_get_config(name, reduced=True).replace(compute_dtype=dtype)
    cfg = get_config(name, reduced=True).replace(compute_dtype=dtype)
    want = np.asarray(jax_source_for_step(jcfg, 2, 0, 3), np.float32)
    got = source_for_step(cfg, 2, 0, 3)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=4)


# ---------------------------------------------------------------------------
# optim/adamw.py
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    for step in range(0, 101):
        want = float(jax_adamw.cosine_schedule(jnp.asarray(step, jnp.int32), **kw))
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=str(step))
    lrs = [float(cosine_schedule(torch.tensor(s), base_lr=1.0, warmup=10, total=100))
           for s in range(100)]
    assert lrs[0] < lrs[9] and lrs[10] == pytest.approx(1.0, rel=0.1)
    assert lrs[99] < 0.2 and min(lrs[10:]) >= 0.099


def _tree(rng, scale, dtype=np.float32):
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(dtype),
            "b": {"c": (rng.standard_normal((3,)) * scale).astype(dtype),
                  "d": (rng.standard_normal((4, 2, 3)) * scale).astype(dtype)}}


@pytest.mark.parametrize("grad_scale,step", [(0.01, 0), (10.0, 0), (0.05, 7), (3.0, 41)])
def test_adamw_update_matches_reference(grad_scale, step):
    """One update on the same numpy inputs: clipped (grad norm above 1) and
    not, at the first step and later ones."""
    rng = np.random.default_rng(step)
    params, grads = _tree(rng, 1.0), _tree(rng, grad_scale)
    mu, nu = _tree(rng, 0.01), jax.tree.map(np.abs, _tree(rng, 1e-3))
    jstate = jax_adamw.AdamWState(jnp.asarray(step, jnp.int32), mu, nu)
    jlr = jax_adamw.cosine_schedule(jnp.asarray(step, jnp.int32), base_lr=1e-3, warmup=5,
                                    total=50)
    jp, js, jm = jax.jit(lambda p, g, s, lr: jax_adamw.adamw_update(p, g, s, lr=lr))(
        params, grads, jstate, jlr)
    state = from_jax(_np(jstate), "cpu")
    lr = cosine_schedule(torch.tensor(step, dtype=torch.int32), base_lr=1e-3, warmup=5,
                         total=50)
    np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
    p, s, m = adamw_update(from_jax(params, "cpu"), from_jax(grads, "cpu"), state,
                           lr=torch.tensor(float(jlr)))
    assert int(s.step) == int(js.step) == step + 1
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for got, want in ((p, jp), (s.mu, js.mu), (s.nu, js.nu)):
        want = dict(tree_items(_np(want)))
        for path, g in tree_items(got):
            w = want[path]
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-6 * float(np.abs(w).max()), err_msg=path)


def test_adamw_optimizes_quadratic_and_clips():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, lr=torch.tensor(0.05),
                                      weight_decay=0.0)
    assert float((params["w"] ** 2).sum()) < 1e-2
    params = {"w": torch.zeros(3)}
    _, _, metrics = adamw_update(params, {"w": torch.tensor([1e6, 0.0, 0.0])},
                                 adamw_init(params), lr=torch.tensor(1.0), clip_norm=1.0)
    assert float(metrics["grad_norm"]) == pytest.approx(1e6)


# ---------------------------------------------------------------------------
# checkpoint/manager.py
# ---------------------------------------------------------------------------

def _state_tree():
    params = {"blocks": {"wq": torch.arange(6.0).reshape(2, 3), "ln": torch.ones(4)},
              "embed": torch.full((3, 2), 0.5)}
    return params, adamw_init(params)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4),
                                                        "h": torch.ones(2, dtype=torch.bfloat16)}}
    for s in (1, 2, 3):
        cm.save(s, tree, extra={"s": s})
    assert cm.steps() == [2, 3]
    got, step, extra = cm.restore(tree)
    assert step == 3 and extra == {"s": 3}
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["h"], tree["b"]["h"])
    assert got["b"]["h"].dtype == torch.bfloat16


def test_checkpoint_corruption_detected(tmp_path):
    cm = CheckpointManager(tmp_path, keep=5)
    tree = {"a": torch.ones(3)}
    cm.save(1, tree)
    cm.save(2, tree)
    (tmp_path / "step_0000000002" / "arrays.npz").write_bytes(b"garbage")
    assert cm.steps() == [1]
    _, step, _ = cm.restore(tree)
    assert step == 1
    with pytest.raises(IOError):
        cm.restore(tree, step=2)


def test_checkpoint_atomicity_no_partial_dir(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(5, {"a": torch.ones(3)})
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    assert sorted(p.name for p in (tmp_path / "step_0000000005").iterdir()) == \
        ["arrays.npz", "meta.json"]


def test_checkpoint_keys_are_the_references():
    """``(params, AdamWState)`` flattens to the reference's ``_keys``:
    ``0/<path>``, ``1/.step``, ``1/.mu/<path>``, ``1/.nu/<path>``."""
    from repro.checkpoint.manager import _keys
    params, state = _state_tree()
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    want = _keys((jparams, jax_adamw.adamw_init(jparams)))
    got = [k for k, _ in _flatten((params, state))]
    assert got == want
    assert "1/.step" in got and "0/blocks/wq" in got and "1/.mu/blocks/ln" in got


def test_checkpoint_port_to_reference(tmp_path):
    params, state = _state_tree()
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    params["blocks"]["wq"] += 1.5
    CheckpointManager(tmp_path).save(7, (params, state), extra={"seq_len": 12})
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                        {k: v for k, v in params.items()})
    (jp, js), step, extra = JaxCheckpointManager(tmp_path).restore(
        (like, jax_adamw.adamw_init(like)))
    assert step == 7 and extra == {"seq_len": 12} and int(js.step) == 7
    for path, t in tree_items(params):
        np.testing.assert_array_equal(dict(tree_items(_np(jp)))[path], t.numpy())


def test_checkpoint_reference_to_port(tmp_path):
    jparams = {"blocks": {"wq": jnp.arange(6.0).reshape(2, 3) - 2.5, "ln": jnp.ones(4)},
               "embed": jnp.full((3, 2), 0.25)}
    jstate = jax_adamw.adamw_init(jparams)._replace(step=jnp.asarray(3, jnp.int32))
    jstate = jstate._replace(mu=jax.tree.map(lambda x: x + 0.125, jstate.mu))
    JaxCheckpointManager(tmp_path).save(3, (jparams, jstate))
    params, state = _state_tree()
    (p, s), step, _ = CheckpointManager(tmp_path).restore((params, state))
    assert step == 3 and int(s.step) == 3 and s.step.dtype == torch.int32
    assert type(s).__name__ == "AdamWState"
    for got, want in ((p, jparams), (s.mu, jstate.mu), (s.nu, jstate.nu)):
        want = dict(tree_items(_np(want)))
        for path, t in tree_items(got):
            np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)


# ---------------------------------------------------------------------------
# train/loop.py
# ---------------------------------------------------------------------------

def _small_loop(path, failure_injector=None, ckpt_every=2, params=None):
    cfg = get_config("gemma-2b", reduced=True)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, base_lr=1e-3, remat=False)
    return TrainLoop(model, cfg, step, seq_len=12, global_batch=2,
                     ckpt_dir=None if path is None else str(path), ckpt_every=ckpt_every,
                     failure_injector=failure_injector, params=params)


def test_train_loop_runs_and_checkpoints(tmp_path):
    hist = _small_loop(tmp_path).run(4)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["step_time_s"] > 0 for h in hist)
    assert set(hist[0]) == {"loss", "grad_norm", "lr", "step_time_s", "step"}
    assert CheckpointManager(tmp_path).steps() == [2, 4]


def test_train_loop_retry_and_resume_give_the_same_losses(tmp_path):
    """An uninterrupted run; one whose step 3 fails once (restored from the
    step-2 checkpoint, steps 2 and 3 rerun); one with no checkpoint whose
    step 1 fails (restarted from scratch); and a 2-step run resumed to 4
    by a new loop: every step's loss bitwise the uninterrupted run's."""
    clean = [h["loss"] for h in _small_loop(tmp_path / "clean").run(4)]

    def injector(at):
        armed = {"on": True}

        def fail(step):
            if step == at and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected node failure")
        return fail

    hist = _small_loop(tmp_path / "retry", injector(3)).run(4)
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3]
    assert [h["loss"] for h in hist] == clean[:3] + clean[2:]
    hist = _small_loop(None, injector(1)).run(4)
    assert [h["step"] for h in hist] == [0, 0, 1, 2, 3]
    assert [h["loss"] for h in hist] == clean[:1] + clean
    _small_loop(tmp_path / "resume").run(2)
    hist = _small_loop(tmp_path / "resume").run(4)
    assert [h["step"] for h in hist] == [2, 3]
    assert [h["loss"] for h in hist] == clean[2:]


def test_train_loop_gives_up_after_max_retries(tmp_path):
    def always(step):
        raise RuntimeError("down for good")
    with pytest.raises(RuntimeError, match="down for good"):
        _small_loop(tmp_path, always).run(2)


def test_train_loop_tracks_reference_losses(tmp_path):
    """The port's loop against the reference's ``TrainLoop`` over 4 steps
    of the reduced gemma-2b, from the same parameters (the reference's
    init, converted): losses within 1e-5 relative."""
    jcfg = jax_get_config("gemma-2b", reduced=True)
    jmodel = jax_build_model(jcfg)
    jstep = jax_make_train_step(jmodel, base_lr=1e-3, remat=False)
    jloop = JaxTrainLoop(jmodel, jcfg, jstep, seq_len=12, global_batch=2,
                         ckpt_dir=str(tmp_path / "jax"), ckpt_every=2)
    want = jloop.run(4)
    params = from_jax(_np(jmodel.init_params(jax.random.PRNGKey(0))), "cpu")
    got = _small_loop(tmp_path / "torch", params=params).run(4)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2, 3]
    for key in ("loss", "lr"):
        np.testing.assert_allclose([h[key] for h in got], [h[key] for h in want], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got[0]["grad_norm"], want[0]["grad_norm"], rtol=1e-5)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def test_train_cli_on_cpu(tmp_path):
    out = tmp_path / "history.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-8b", "--reduced",
         "--device", "cpu", "--steps", "3", "--seq-len", "16", "--global-batch", "2",
         "--ckpt-dir", str(tmp_path / "ckpt"), "--metrics-out", str(out)],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "tok/s" in res.stderr
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert CheckpointManager(tmp_path / "ckpt").latest_step() == 3
    with pytest.raises(RuntimeError, match="world of 256 ranks"):   # no torchrun world
        train_cli.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                        "--production-mesh"])
