"""The port's recurrent layers (``repro_torch.models.rwkv6`` and
``repro_torch.models.mamba``) against the reference's functions on the same
numpy inputs and the reference's weights converted leaf for leaf.

float32 outputs and states within 1e-5 absolute (the layers are small:
d 64, head 16, state 4; summation orders differ, nothing else): RWKV6's
time mix and channel mix from a zero and from a carried state, with and
without right padding (``n_valid``), and their decode steps with a ragged
``active`` mask; Mamba's sequence form (``return_state``, ``state=``,
``n_valid=``) and decode step. Padded positions are exact no-ops: the
state after a padded chunk does not depend on what the padding holds, and
inactive rows of a decode step keep their state bit for bit. Also: the
port's ``sigmoid`` and ``softplus`` bitwise ``jax.nn.sigmoid`` /
``jax.nn.softplus`` on every finite bf16 input (where XLA does not flush a
denormal result to zero), the FMA that XLA's CPU code makes of a lerp (see
``_torch_parity.NEAR_TIES``), and which projections ``+w4a8`` quantizes."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat
from repro.models import mamba as jax_mamba
from repro.models import rwkv6 as jax_rwkv
from repro.models.api import build_model as jax_build_model
from repro.configs import get_config as jax_get_config
from repro.models.quantized import quantize_params as jax_quantize_params
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models import mamba, rwkv6
from repro_torch.models.api import build_model
from repro_torch.models.layers import sigmoid, softplus
from repro_torch.models.quantized import quantize_params

ATOL = 1e-5
B, S, D, HEAD, D_FF = 3, 20, 64, 16, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many tiny ops; with the suite's workers sharing the
    cores, PyTorch's waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, err_msg=what)


def _rwkv_params(seed=0):
    p = jax_rwkv.rwkv_layer_init(jax.random.PRNGKey(seed), D, D_FF, HEAD)
    # non-trivial mixes, bonus and decay base, so that each coefficient matters
    rng = np.random.default_rng(seed)
    p = dict(_np(p))
    p["mix_rkvwg"] = rng.uniform(0.1, 0.9, p["mix_rkvwg"].shape).astype(np.float32)
    p["mix_ffn"] = rng.uniform(0.1, 0.9, p["mix_ffn"].shape).astype(np.float32)
    p["u"] = rng.normal(0, 0.5, p["u"].shape).astype(np.float32)
    p["w0"] = rng.uniform(-3, 0, p["w0"].shape).astype(np.float32)
    return p, from_jax(p, "cpu")


def _rwkv_state(rng, carried):
    h = D // HEAD
    if not carried:
        z = lambda *s: np.zeros(s, np.float32)
        return z(B, D), z(B, D), z(B, h, HEAD, HEAD)
    return (rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(B, h, HEAD, HEAD)).astype(np.float32))


def _states(mod, arrays, torch_side):
    cls = mod.RWKVLayerState if hasattr(mod, "RWKVLayerState") else mod.MambaState
    return cls(*(_t(a) for a in arrays)) if torch_side else cls(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("n_valid", [None, 13], ids=["full", "padded"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero-state", "carried-state"])
def test_rwkv_time_and_channel_mix_match_reference(carried, n_valid):
    jp, tp = _rwkv_params()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    st = _rwkv_state(rng, carried)
    jy, jst = jax_rwkv.rwkv_time_mix(jp, jnp.asarray(x), _states(jax_rwkv, st, False), HEAD,
                                     n_valid=None if n_valid is None else jnp.int32(n_valid))
    ty, tst = rwkv6.rwkv_time_mix(tp, _t(x), _states(rwkv6, st, True), HEAD, n_valid=n_valid)
    _close(ty, jy, "time mix output")
    for name, got, want in zip(tst._fields, tst, jst):
        _close(got, want, f"time mix state {name}")
    jy2, jst2 = jax_rwkv.rwkv_channel_mix(jp, jnp.asarray(x), jst,
                                          None if n_valid is None else jnp.int32(n_valid))
    ty2, tst2 = rwkv6.rwkv_channel_mix(tp, _t(x), tst, n_valid)
    _close(ty2, jy2, "channel mix output")
    _close(tst2.x_prev_ffn, jst2.x_prev_ffn, "channel mix carry")


def test_rwkv_steps_match_reference_and_park_inactive_rows():
    jp, tp = _rwkv_params()
    rng = np.random.default_rng(2)
    st = _rwkv_state(rng, True)
    active = np.array([True, False, True])
    jst, tst = _states(jax_rwkv, st, False), _states(rwkv6, st, True)
    for step in range(3):
        x = rng.normal(size=(B, D)).astype(np.float32)
        jy, jst = jax_rwkv.rwkv_time_mix_step(jp, jnp.asarray(x), jst, HEAD,
                                              active=jnp.asarray(active))
        ty, tst = rwkv6.rwkv_time_mix_step(tp, _t(x), tst, HEAD, active=_t(active))
        _close(ty, jy, f"time mix step {step}")
        jy2, jst = jax_rwkv.rwkv_channel_mix_step(jp, jnp.asarray(x), jst,
                                                  active=jnp.asarray(active))
        ty2, tst = rwkv6.rwkv_channel_mix_step(tp, _t(x), tst, active=_t(active))
        _close(ty2, jy2, f"channel mix step {step}")
        for name, got, want in zip(tst._fields, tst, jst):
            _close(got, want, f"step {step} state {name}")
    for got, start in zip(tst, st):               # the inactive row: bit for bit
        assert torch.equal(got[1], _t(start)[1])


def _mamba_params(seed=0):
    p = _np(jax_mamba.mamba_init(jax.random.PRNGKey(seed), D, state=4, conv=4, expand=2))
    p = dict(p)
    p["dt_bias"] = np.random.default_rng(seed).normal(0, 0.5, p["dt_bias"].shape).astype(
        np.float32)
    return p, from_jax(p, "cpu")


@pytest.mark.parametrize("n_valid", [None, 11], ids=["full", "padded"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero-state", "carried-state"])
def test_mamba_forward_matches_reference(carried, n_valid):
    jp, tp = _mamba_params()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    st = None
    if carried:
        st = (rng.normal(size=(B, 3, 2 * D)).astype(np.float32),
              rng.normal(size=(B, 2 * D, 4)).astype(np.float32))
    jy, jst = jax_mamba.mamba_forward(
        jp, jnp.asarray(x), return_state=True,
        state=None if st is None else _states(jax_mamba, st, False),
        n_valid=None if n_valid is None else jnp.int32(n_valid))
    ty, tst = mamba.mamba_forward(tp, _t(x), return_state=True,
                                  state=None if st is None else _states(mamba, st, True),
                                  n_valid=n_valid)
    _close(ty, jy, "mamba output")
    _close(tst.conv, jst.conv, "conv tail")
    _close(tst.ssm, jst.ssm, "ssm state")
    assert tst.conv.dtype == tst.ssm.dtype == torch.float32
    plain = mamba.mamba_forward(tp, _t(x), state=None if st is None else
                                _states(mamba, st, True), n_valid=n_valid)
    assert torch.equal(plain, ty)


def test_mamba_decode_steps_match_reference_and_park_inactive_rows():
    jp, tp = _mamba_params()
    rng = np.random.default_rng(4)
    st0 = jax_mamba.mamba_init_state(jp, B)
    tst = mamba.mamba_init_state(tp, B)
    for got, want in zip(tst, st0):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    st = (rng.normal(size=(B, 3, 2 * D)).astype(np.float32),
          rng.normal(size=(B, 2 * D, 4)).astype(np.float32))
    jst, tst = _states(jax_mamba, st, False), _states(mamba, st, True)
    active = np.array([False, True, True])
    for step in range(3):
        x = rng.normal(size=(B, D)).astype(np.float32)
        jy, jst = jax_mamba.mamba_decode_step(jp, jnp.asarray(x), jst,
                                              active=jnp.asarray(active))
        ty, tst = mamba.mamba_decode_step(tp, _t(x), tst, active=_t(active))
        _close(ty, jy, f"decode step {step}")
        _close(tst.conv, jst.conv, f"step {step} conv")
        _close(tst.ssm, jst.ssm, f"step {step} ssm")
    for got, start in zip(tst, st):
        assert torch.equal(got[0], _t(start)[0])


def test_padding_is_an_exact_noop():
    """The state after a right-padded chunk does not depend on what the
    padded positions hold (same shapes, so the same arithmetic), in both
    recurrences, bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    other = x.copy()
    other[:, 9:] = rng.normal(size=(B, S - 9, D)) * 10
    _, tp = _rwkv_params()
    st = _states(rwkv6, _rwkv_state(rng, True), True)
    a = rwkv6.rwkv_time_mix(tp, _t(x), st, HEAD, n_valid=9)[1]
    b = rwkv6.rwkv_time_mix(tp, _t(other), st, HEAD, n_valid=9)[1]
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(a.x_prev_att, _t(x)[:, 8])
    assert torch.equal(rwkv6.rwkv_channel_mix(tp, _t(other), a, 9)[1].x_prev_ffn, _t(x)[:, 8])
    _, mp = _mamba_params()
    a = mamba.mamba_forward(mp, _t(x), return_state=True, n_valid=9)[1]
    b = mamba.mamba_forward(mp, _t(other), return_state=True, n_valid=9)[1]
    assert torch.equal(a.conv, b.conv) and torch.equal(a.ssm, b.ssm)


def _every_bf16():
    bits = np.arange(65536, dtype=np.uint16).view(np.int16).copy()
    x = torch.from_numpy(bits).view(torch.bfloat16)
    return x[torch.isfinite(x)]


@pytest.mark.parametrize("name", ["sigmoid", "softplus"])
def test_activation_bitwise_on_every_bf16_input(name):
    """Each op rounding in bf16, as ``jax.nn.sigmoid`` (``1 / (1 +
    exp(-x))``) and ``jax.nn.softplus`` (``logaddexp(x, 0)`` written out)
    lower on XLA's CPU: equal on all 65280 finite inputs but the tiny
    results that XLA flushes to zero."""
    port, ref = {"sigmoid": (sigmoid, jax.nn.sigmoid),
                 "softplus": (softplus, jax.nn.softplus)}[name]
    x = _every_bf16()
    want = np.asarray(jax.jit(ref)(jnp.asarray(x.float().numpy(), jnp.bfloat16))
                      .astype(jnp.float32))
    got = port(x).float().numpy()
    differ = want != got
    flushed = differ & (want == 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    assert x.numel() == 65280 and differ.sum() == flushed.sum() < 20, (differ.sum(),
                                                                       flushed.sum())
    xf = np.random.default_rng(0).normal(0, 30, 10000).astype(np.float32)
    np.testing.assert_allclose(port(_t(xf)).numpy(), np.asarray(jax.jit(ref)(xf)),
                               rtol=1e-6, atol=1e-7)


def test_xla_contracts_a_lerp_into_an_fma():
    """Why +w4a8 parity allows near-tie code flips (``NEAR_TIES``): on the
    CPU, XLA computes ``x * m + y * (1 - m)`` as ``fma(x, m, y * (1 - m))``,
    one rounding fewer than the same ops written out in PyTorch."""
    rng = np.random.default_rng(6)
    x, y = (rng.normal(size=(4096,)).astype(np.float32) for _ in range(2))
    m = rng.uniform(0, 1, 4096).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y, m: x * m + y * (1 - m))(x, y, m))
    tx, ty, tm = _t(x), _t(y), _t(m)
    assert (want != (tx * tm + ty * (1 - tm)).numpy()).sum() > 0
    np.testing.assert_array_equal(torch.addcmul(ty * (1 - tm), tx, tm).numpy(), want)


@pytest.mark.parametrize("name", ["rwkv6-3b+w4a8", "hymba-1.5b+ring+w4a8"])
def test_w4a8_quantizes_the_reference_projections(name):
    """``+w4a8`` quantizes RWKV6's wk/wv/wo and hymba's attention and MLP
    projections; RWKV6's wr/wg/fk/fv/fr and every Mamba projection stay
    dense (the reference's ``QUANT_KEYS``). The trees are equal leaf for
    leaf, packed codes and scales included."""
    params = jax_build_model(jax_get_config(name, reduced=True)).init_params(
        jax.random.PRNGKey(0))
    want = dict(flat(_np(jax_quantize_params(params))))
    got = dict(flat(quantize_params(from_jax(_np(params), "cpu"))))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
    quantized = {k.rsplit("/", 1)[1][:-4] for k in got if k.endswith("__qp")}
    dense = {k.rsplit("/", 1)[1] for k in got if got[k].dim() == 3 and "__" not in k}
    if name.startswith("rwkv"):
        assert quantized == {"wk", "wv", "wo"}
        assert {"wr", "wg", "fk", "fv", "fr", "w_a", "w_b"} <= dense
    else:
        assert quantized == {"wq", "wk", "wv", "wo", "up", "gate", "down"}
        assert {"in_proj", "x_proj", "out_proj"} <= dense


@pytest.mark.parametrize("name", ["rwkv6-3b", "hymba-1.5b"])
def test_init_params_tree_matches_reference(name):
    """The port's own random init has the reference's tree: the same leaves,
    shapes and (float32) dtypes; with ``dtype=bf16`` only the matrices are
    bf16, the small leaves stay float32."""
    want = {k: (v.shape, v.dtype.name) for k, v in
            flat(_np(jax_build_model(jax_get_config(name, reduced=True)).init_params(
                jax.random.PRNGKey(0))))}
    model = build_model(get_config(name, reduced=True), device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in flat(model.init_params(0))}
    assert got == want
    bf16 = {k for k, v in flat(model.init_params(0, dtype=torch.bfloat16))
            if v.dtype == torch.bfloat16}
    small = ("mix_rkvwg", "mix_ffn", "w0", "u", "ln_x", "conv_w", "a_log", "dt_w", "dt_bias",
             "d_skip", "ln1", "ln2", "ln_f", "ln_attn_out", "ln_mamba_out")
    assert bf16 and not {k for k in bf16 if k.rsplit("/", 1)[-1] in small}
