"""The pure half of the roofline and the sharding constraints, on the CPU:

* ``distributed/roofline.py``: ``count_params`` and
  ``model_flops_for_cell`` equal the reference's exactly for every config
  and shape cell; the counterparts of ``tests/test_distributed.py``'s
  roofline tests with the H100 SXM's constants;
* the four sharding constraints (``layers.maybe_constrain``,
  ``layers.batch_vocab_constrain``, ``attention._heads_constrain``,
  ``TransformerLM._seq_shard``), ``sharding.split_dim`` / ``merge_dims`` /
  ``matmul_rows`` and ``lm_loss``'s masked-sum pick are bitwise no-ops on
  plain tensors, outside a distribution context and inside one; so is a
  whole forward of a model without experts; the MoE takes its
  expert-parallel route under a context whether autograd records ``x`` or
  not.

The constraints' work on ``DTensor`` s is held by the 4-rank world of
``tests/test_torch_dist_world.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import roofline as jax_roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import attention
from repro_torch.distributed import roofline, sharding
from repro_torch.distributed.context import clear_context, set_context
from repro_torch.models import layers, moe
from repro_torch.models.api import build_model, lm_loss
from repro_torch.models.transformer import TransformerLM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: with the suite's workers sharing the cores, PyTorch's
    waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _FakeMesh:
    """What the context reads of a mesh: names and sizes."""
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


@pytest.fixture(params=["outside", "inside"])
def context(request):
    """No distribution context, or one over a (data 2, model 2) mesh."""
    if request.param == "inside":
        set_context(_FakeMesh(), batch_axes=("data",), model_axis="model")
    yield request.param
    clear_context()


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.count_params(cfg) == jax_roofline.count_params(jcfg)
    assert roofline.model_flops_for_cell(cfg, SHAPES[shape]) == \
        jax_roofline.model_flops_for_cell(jcfg, JAX_SHAPES[shape])


def test_h100_constants():
    """One H100 SXM at 700 W: dense bf16, HBM3 and NVLink 4 each way; the
    first two are the peaks ``chip_smoke.py`` holds kernels to."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert {"ICI_BW"} & set(vars(roofline)) == set()


def test_roofline_terms_and_dominance():
    rep = roofline.RooflineReport(
        arch="x", shape="y", mesh="16x16", n_chips=256,
        hlo_flops=989e12 * 0.001,            # 1 ms compute
        hlo_bytes=3.35e12 * 0.002,           # 2 ms memory
        collective_op_bytes=0,
        collective_ici_bytes=450e9 * 0.0005,  # 0.5 ms collective
        bytes_per_chip=1e9, model_flops=989e12 * 0.001 * 256 * 0.5).finalize()
    assert rep.dominant == "memory"
    assert rep.t_bound == pytest.approx(0.002)
    assert rep.useful_flops_fraction == pytest.approx(0.5)
    assert rep.roofline_fraction == pytest.approx(0.25)
    row = rep.row()
    assert row["t_memory_ms"] == pytest.approx(2.0) and row["dominant"] == "memory"


def test_model_flops_moe_counts_active_only():
    total, active = roofline.count_params(get_config("olmoe_1b_7b"))
    assert active < total * 0.35                     # 8 of 64 experts
    t2, a2 = roofline.count_params(get_config("qwen3_8b"))
    assert t2 == a2
    assert 7e9 < t2 < 9.5e9, t2                      # qwen3-8b: ~8B parameters


def test_count_params_vlm_includes_cross_layers():
    total, _ = roofline.count_params(get_config("llama32_vision_90b"))
    assert 80e9 < total < 110e9, total


# ---------------------------------------------------------------------------
# the constraints on plain tensors
# ---------------------------------------------------------------------------

def test_constraints_are_no_ops_on_plain_tensors(context):
    x = torch.randn(4, 16, 64)
    heads = torch.randn(4, 8, 16, 32)
    assert layers.maybe_constrain(x, "data", "model", None) is x
    assert layers.batch_vocab_constrain(x) is x
    assert attention._heads_constrain(heads) is heads
    assert TransformerLM._seq_shard(x) is x
    assert sharding.constrain(x, ("data", None, None)) is x
    w = torch.randn(64, 80)
    y = sharding.matmul_rows(x, w)
    assert torch.equal(y, x @ w)
    split = sharding.split_dim(y, -1, (5, 16))
    assert torch.equal(split, y.reshape(4, 16, 5, 16))
    assert torch.equal(sharding.merge_dims(split, 2), y)
    assert sharding.replicated_value(x) is x


def test_masked_sum_pick_is_the_gather():
    """``lm_loss`` picks each label's logit by a masked sum over the vocab;
    on plain tensors its loss and the logits' gradient are bitwise those of
    the ``gather`` pick."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 7, 503)).astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(0, 503, (3, 7)).astype(np.int32))
    aux = torch.tensor(0.37)

    class Stub:
        def forward(self, params, tokens, *, remat):
            return params["logits"], aux

    def gather_loss(lg):
        picked = lg.gather(-1, labels.long()[..., None])[..., 0]
        return torch.mean(torch.logsumexp(lg, dim=-1) - picked) + 0.01 * aux

    got_in = logits.clone().requires_grad_(True)
    got = lm_loss(Stub(), {"logits": got_in}, labels, labels)
    got.backward()
    want_in = logits.clone().requires_grad_(True)
    want = gather_loss(want_in)
    want.backward()
    assert torch.equal(got, want)
    assert torch.equal(got_in.grad, want_in.grad)


@pytest.mark.parametrize("name", ["llama2-7b", "hymba-1.5b"])
def test_forward_is_unchanged_inside_a_context(name):
    """A whole reduced forward on plain tensors (every constraint site, the
    sequence gathers, the unembed's pin; on hymba the uneven head split and
    the SSM scan) gives the same bits and gradients inside a (data 2, model
    2) context as outside one. (A MoE under a context takes the
    expert-parallel route, which needs a real mesh: the 4-rank world of
    ``tests/test_torch_dist_world.py`` holds it.)"""
    model = build_model(get_config(name, reduced=True), device="cpu")
    params = model.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 503, (4, 16)))

    def run():
        p = {k: v.detach().clone().requires_grad_(True) if k == "embed" else v
             for k, v in params.items()}
        loss = lm_loss(model, p, tokens, tokens)
        loss.backward()
        return loss.detach(), p["embed"].grad

    want = run()
    set_context(_FakeMesh(), batch_axes=("data",), model_axis="model")
    try:
        got = run()
    finally:
        clear_context()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_moe_route_under_a_context(monkeypatch):
    """The MoE's route: the single-process dispatch outside a context; under
    one the expert-parallel route for a plain ``x``, recorded by autograd
    or not, as the reference has the one route under a context."""
    cfg = get_config("olmoe-1b-7b", reduced=True)
    p = {k: v[0] for k, v in build_model(cfg, device="cpu").init_params(0)["blocks"]["ffn"].items()}
    x = torch.randn(4, 8, cfg.d_model)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    taken = []
    monkeypatch.setattr(moe, "_moe_apply_ep", lambda *a, **k: taken.append(1) or (None, None))
    y, _ = moe.moe_apply(p, x, **kw)
    assert taken == [] and y.shape == x.shape
    set_context(_FakeMesh(), batch_axes=("data",), model_axis="model")
    try:
        moe.moe_apply(p, x, **kw)
        moe.moe_apply(p, x.clone().requires_grad_(True), **kw)
    finally:
        clear_context()
    assert taken == [1, 1]
