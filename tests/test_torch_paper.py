"""The paper's evaluation on the port (``repro_torch.paper``) against the
reference's (``benchmarks/``), on the CPU:

* ``paper/edge_cost_model.py``: every constant, every cycle function over
  a grid of contexts, blocks and head dims, ``speedups_at``, ``calibrate``,
  the two ``EdgeModel`` s and ``decode_latency_breakdown`` under every
  schedule, bitwise (``==`` on floats: a copy of pure-Python arithmetic);
* fig7a, fig8a, table3 and fig7b's ``model`` / ``paper`` /
  ``calibration``: equal to the reference's dicts; ``lut_exp_error``
  equal;
* ``fxp_attention_precision``: the Q15.17 datapath is the same numpy code
  in both, and the oracle is float32 softmax attention, torch against
  XLA: errors within FXP_ATOL of the reference's, booleans equal;
* table1: the reference's own function runs (its steps' losses and its two
  forwards' logits recorded as it goes) and the port's from the same
  initial parameters (the reference's ``init_params(PRNGKey(0))``
  converted): every step's loss within LOSS_RTOL, both forwards' logits
  within LOGIT_ATOL of max |logit|, the Top-k fractions and their sets
  equal (a set that differs across the frameworks is a fault, reported
  with its logit gap);
* ``run.main`` (``--device cpu --skip-slow``) exits 0 and its CSV has the
  reference run's ``name,metric`` pairs, the wall-clock keys apart; with
  no GPU and no ``--device`` it raises (``test_torch_serving.py``);
* ``roofline_table.markdown`` renders the report of a reduced dry-run
  cost pass written into ``tmp_path``, and ``tools/dryrun_table.py`` reads
  the same directory through the same loader.

~35 s on one worker (the reference's table1 ~14 s, its jitted fig7b, the
dry-run subprocess ~7 s).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:        # the reference's benchmarks/ is a top-level folder
    sys.path.insert(0, str(ROOT))

from benchmarks import edge_cost_model as jax_ecm  # noqa: E402
from benchmarks import paper_figures as jax_pf  # noqa: E402
from benchmarks import run as jax_run  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.paper import edge_cost_model as ecm  # noqa: E402
from repro_torch.paper import paper_figures as pf  # noqa: E402
from repro_torch.paper import roofline_table  # noqa: E402
from repro_torch.paper import run as paper_run  # noqa: E402

# the measured gaps on this reduced run: fxp errors 7.8e-8 apart (of ~3e-5),
# losses 4.9e-7 relative at worst over the 60 steps, logits 4.4e-6 of max
# |logit|; each tolerance ~10-20x its gap
FXP_ATOL = 1e-6      # two float32 oracles' summation orders apart
LOSS_RTOL = 1e-5     # 60 AdamW steps at lr 3e-3, torch against XLA in float32
LOGIT_ATOL = 5e-5    # of max |logit|, after those 60 steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# edge_cost_model.py: the port's copy against the reference's, bitwise
# ---------------------------------------------------------------------------

CONSTANTS = ("D_HEAD", "LANES", "DOT", "CLOCK_HZ", "HBM_BPS", "HBM_EFF", "KV_BYTES_PER_ELT",
             "EXP_LAT", "DIV_LAT", "SCORE_RW", "FILL")
CONTEXTS = (1, 7, 64, 100, 128, 256, 511, 512, 1024, 4096, 32768)
HEAD_DIMS = (64, 128, 256)


def test_cost_model_constants_are_the_references():
    for name in CONSTANTS:
        assert getattr(ecm, name) == getattr(jax_ecm, name), name
    assert [f.name for f in dataclasses.fields(ecm.EdgeModel)] == \
        [f.name for f in dataclasses.fields(jax_ecm.EdgeModel)]
    for name in ("LLAMA2_7B", "CHATGLM_6B"):
        mine, ref = getattr(ecm, name), getattr(jax_ecm, name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name
        assert (mine.weight_bytes, mine.kv_frac) == (ref.weight_bytes, ref.kv_frac), name


@pytest.mark.parametrize("fn", ["swiftkv_cycles", "native_cycles", "streaming_cycles"])
def test_cost_model_schedules_bitwise(fn):
    for n in CONTEXTS:
        for d in HEAD_DIMS:
            assert getattr(ecm, fn)(n, d) == getattr(jax_ecm, fn)(n, d), (fn, n, d)
        assert getattr(ecm, fn)(n) == getattr(jax_ecm, fn)(n), (fn, n)


def test_cost_model_flash_bitwise():
    for n in CONTEXTS:
        for block in (1, 8, 16, 32, 64, 128):
            for d in HEAD_DIMS:
                assert ecm.flash_cycles(n, block, d) == jax_ecm.flash_cycles(n, block, d)


def test_cost_model_speedups_and_calibration_bitwise():
    for n in CONTEXTS:
        assert ecm.speedups_at(n) == jax_ecm.speedups_at(n), n
    assert ecm.speedups_at() == jax_ecm.speedups_at()
    assert ecm.calibrate() == jax_ecm.calibrate()


@pytest.mark.parametrize("attention", ["swiftkv", "native", "streaming", "flash"])
def test_cost_model_breakdown_bitwise(attention):
    for name in ("LLAMA2_7B", "CHATGLM_6B"):
        for block in (8, 16, 32):
            for ctx in (512, 4096):
                mine = dataclasses.replace(getattr(ecm, name), ctx=ctx)
                ref = dataclasses.replace(getattr(jax_ecm, name), ctx=ctx)
                assert ecm.decode_latency_breakdown(mine, attention=attention,
                                                    flash_block=block) == \
                    jax_ecm.decode_latency_breakdown(ref, attention=attention,
                                                     flash_block=block), (name, block, ctx)


def test_cost_model_imports_nothing_of_the_reference():
    """The port's copy is its own module: pure Python, no ``benchmarks``."""
    src = Path(ecm.__file__).read_text()
    assert "benchmarks" not in src.replace("``benchmarks/edge_cost_model.py``", "") \
        .replace("``benchmarks``", "")
    assert "import jax" not in src and "repro." not in src


# ---------------------------------------------------------------------------
# the figures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fig7a_context_sweep", "fig8a_breakdown",
                                  "table3_tokens_per_s", "lut_exp_error"])
def test_figure_equals_the_references(name):
    assert getattr(pf, name)() == getattr(jax_pf, name)()


def test_fig7b_model_and_calibration_equal_the_references():
    ref = jax_pf.fig7b_speedup()
    mine = pf.fig7b_speedup(device="cpu")
    for key in ("model", "paper", "calibration"):
        assert mine[key] == ref[key], key
    clock = mine["wall_clock"]
    assert set(clock) == {"device", "blockwise_us", "naive_us"} and clock["device"] == "cpu"
    assert clock["blockwise_us"] > 0 and clock["naive_us"] > 0
    assert set(ref["cpu_wall_clock"]) == {"blockwise_us", "naive_us"}


def test_fig7b_inputs_are_the_references():
    """Seed-0 numpy, float32, in the reference's order q, k, v; the blockwise
    and naive paths agree on them as the reference's do."""
    from repro_torch.core import swiftkv as sk
    rng = np.random.default_rng(0)
    want = [rng.standard_normal(128), rng.standard_normal((512, 128)),
            rng.standard_normal((512, 128))]
    got = pf.fig7b_inputs("cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), w.astype(np.float32))
    q, k, v = got
    a = sk.swiftkv_decode_blockwise(q[None, None, None], k[None, :, None], v[None, :, None],
                                    block_size=128)
    b = sk.softmax_attention_reference(q[None, None, None], k[None, :, None],
                                       v[None, :, None])
    assert torch.allclose(a, b, atol=1e-5)


def test_fxp_attention_precision_near_the_references():
    ref = jax_pf.fxp_attention_precision(trials=3)
    mine = pf.fxp_attention_precision(trials=3)
    assert set(mine) == set(ref)
    for key in ("max_abs_err", "mean_abs_err"):
        assert abs(mine[key] - ref[key]) <= FXP_ATOL, (key, mine[key], ref[key])
    assert (mine["paper_claim"], mine["mean_below_claim"]) == \
        (ref["paper_claim"], ref["mean_below_claim"])


def test_table1_tracks_the_reference(monkeypatch):
    """The reference's ``table1_topk_agreement`` as it stands, with its
    init, every step's loss and its two forwards' logits recorded; the port
    trained from the same init (converted)."""
    from repro.models import api as jax_api
    init, losses, logits = [], [], []
    real_build, real_jit = jax_api.build_model, jax.jit

    def building(cfg):
        model = real_build(cfg)
        real_init, real_forward = model.init_params, model.forward

        def init_params(key):
            params = real_init(key)
            init.append(jax.tree.map(np.asarray, params))
            return params

        def forward(*args, **kw):
            out = real_forward(*args, **kw)
            if not isinstance(out[0], jax.core.Tracer):      # the two forwards after training
                logits.append(np.asarray(out[0]).reshape(-1, cfg.vocab_size))
            return out
        model.init_params, model.forward = init_params, forward
        return model

    def jitting(fn, **kw):                                   # the training step
        step = real_jit(fn, **kw)

        def call(*args):
            out = step(*args)
            losses.append(float(out[2]))
            return out
        return call
    monkeypatch.setattr(jax_api, "build_model", building)
    monkeypatch.setattr(jax, "jit", jitting)
    ref = jax_pf.table1_topk_agreement()
    monkeypatch.undo()
    assert len(init) == 1 and len(losses) == 60 and len(logits) == 2

    mine, my_losses, my_ref, my_q = pf.table1_run(device="cpu",
                                                  params=from_jax(init[0], "cpu"))
    np.testing.assert_allclose(my_losses, losses, rtol=LOSS_RTOL)
    for got, want in ((my_ref, logits[0][:64]), (my_q, logits[1][:64])):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= LOGIT_ATOL * scale
    assert mine["paper"] == ref["paper"]
    assert mine["final_train_loss"] == pytest.approx(ref["final_train_loss"], rel=LOSS_RTOL)
    if mine["agreement"] != ref["agreement"]:
        # a Top-k set that differs across the frameworks: report it with the
        # logit gap at the k-th place of the reference's W4 logits
        want = logits[1][:64]
        top = -np.sort(-want, axis=-1)
        gaps = {k: float(np.min(top[:, k - 1] - top[:, k])) for k in (1, 2, 3, 5)}
        pytest.fail(f"table1: Top-k agreement {mine['agreement']} != the reference's "
                    f"{ref['agreement']}; smallest k-th/(k+1)-th logit gaps {gaps}")


# ---------------------------------------------------------------------------
# run.py and the roofline table
# ---------------------------------------------------------------------------

def _csv(text: str) -> dict:
    lines = text.split("name,metric,value\n", 1)[1].splitlines()
    rows = [ln.split(",", 2) for ln in lines if ln.count(",") >= 2]
    return {(n, m): v for n, m, v in rows}


def test_run_main_matches_the_reference_harness(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = paper_run.main(["--device", "cpu", "--skip-slow", "--json",
                             str(tmp_path / "port.json"), "--reports", str(tmp_path / "none")])
    out = buf.getvalue()
    assert rc == 0, out
    assert "[skip] roofline table:" in out
    for name in ("fig7a_context_sweep", "fig7b_speedup", "lut_exp_error",
                 "fxp_attention_precision", "fig8a_breakdown", "table3_tokens_per_s"):
        assert f"[ok] {name} (" in out, name
    ref_buf = io.StringIO()
    with redirect_stdout(ref_buf):
        assert jax_run.main(["--skip-slow", "--json", str(tmp_path / "ref.json"),
                             "--reports", str(tmp_path / "none")]) == 0
    mine, ref = _csv(out), _csv(ref_buf.getvalue())
    clock = lambda rows: {k for k in rows if "wall_clock" in k[1]}
    assert {k[1] for k in clock(mine)} == {"wall_clock.blockwise_us", "wall_clock.naive_us"}
    assert {k[1] for k in clock(ref)} == {"cpu_wall_clock.blockwise_us",
                                          "cpu_wall_clock.naive_us"}
    assert set(mine) - clock(mine) == set(ref) - clock(ref)
    saved = json.loads((tmp_path / "port.json").read_text())
    assert set(saved) == {"fig7a_context_sweep", "fig7b_speedup", "lut_exp_error",
                          "fxp_attention_precision", "fig8a_breakdown", "table3_tokens_per_s"}
    assert saved["fig7b_speedup"]["wall_clock"]["device"] == "cpu"


def test_run_main_reports_a_failed_figure(tmp_path, monkeypatch, capsys):
    """A figure that raises is reported ``[FAIL]`` and the harness returns 1."""
    def broken():
        raise RuntimeError("boom")
    monkeypatch.setattr(pf, "lut_exp_error", broken)
    rc = paper_run.main(["--device", "cpu", "--skip-slow", "--json",
                         str(tmp_path / "p.json"), "--reports", str(tmp_path / "none")])
    out = capsys.readouterr().out
    assert rc == 1 and "[FAIL] lut_exp_error (-s)" in out and "[ok] fig8a_breakdown" in out
    assert json.loads((tmp_path / "p.json").read_text())["lut_exp_error"] == \
        {"error": "RuntimeError: boom"}


def test_roofline_table_renders_a_reduced_dryrun(tmp_path):
    """A reduced dry-run cost pass (qwen3-8b decode_32k, 16x16) written where
    the sweep writes it renders as a row with its three terms; every other
    cell is missing; ``tools/dryrun_table.py`` reads the same directory."""
    out = tmp_path / "qwen3_8b__decode_32k__sp__unroll.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen3-8b", "--shape", "decode_32k", "--cost", "--reduced",
                          "--json", str(out)], capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    (tmp_path / "summary.json").write_text("[]")          # not a pass: left out
    reports = roofline_table.load_reports(str(tmp_path))
    assert list(reports) == ["qwen3_8b__decode_32k__sp__unroll"]
    rep = reports["qwen3_8b__decode_32k__sp__unroll"]
    t = roofline_table.table(str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in t["rows"]] == [("qwen3_8b", "decode_32k")]
    row = t["rows"][0]
    for col in roofline_table.COLS:
        assert row[col] == round(rep["roofline"][col], 3)
    assert row["fits"] == rep["memory"]["fits_80gb"] and row["mode"] == "unroll-extrap"
    assert len(t["fails"]) == len(roofline_table.ASSIGNED_ARCHS) * len(roofline_table.SHAPES) - 1
    md = roofline_table.markdown(str(tmp_path))
    assert md.splitlines()[2].startswith("| qwen3_8b | decode_32k | ")
    assert "Failures: " in md and "qwen3_8bxdecode_32k" not in md
    tool = subprocess.run([sys.executable, str(ROOT / "tools" / "dryrun_table.py"),
                           str(tmp_path)], capture_output=True, text=True, env=env,
                          timeout=120)
    assert tool.returncode == 0, tool.stderr
    assert tool.stdout.startswith("1 passes: 1 ok, 0 skipped, 0 failed")
    assert "| qwen3-8b | - | - | - / - GB; " in tool.stdout      # the arch as the CLI got it


def test_roofline_table_without_reports_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no dry-run reports"):
        roofline_table.markdown(str(tmp_path / "absent"))
