"""The port's training loss and gradients against the reference's for the
recurrent and cross-attention families at reduced size: rwkv6-3b (RWKV6,
the WKV scan), hymba-1.5b (attention beside a Mamba branch), and, with
every cross gate at 0.5 (``_torch_parity.XATTN_GATE``: at the reference's
init of 0 a wrong cross read would still match), llama-3.2-vision-90b and
whisper-small (encoder then decoder). float32, the reference's weights
converted leaf for leaf, one counted batch; the recurrent configs take 80
tokens, so the scans cross their 64-token block boundary. Tolerances:
``_torch_parity.LOSS_RTOL`` and ``GRAD_RTOL`` (measured: at most 4.5e-6 of
a leaf's largest gradient).

The scans' gradient form (a new tensor per state, stacked, each 64-token
block checkpointed) against the serving form (``addcmul(out=)`` into one
buffer): the serving outputs are bitwise those of the loop the port had
before the gradient form (kept here as ``_old_wkv_scan`` /
``_old_ssm_scan``), and the gradient form gives the same bits. Remat off,
``"full"`` and ``"dots"`` give equal losses and gradients bit for bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import check_loss_and_grads, counted_batch, pair
from repro_torch.models import mamba, rwkv6
from repro_torch.models.api import build_model, lm_loss
from repro_torch.train.step import _value_and_grad
from repro_torch.tree import tree_items

NAMES = ["rwkv6-3b", "hymba-1.5b", "llama-3.2-vision-90b", "whisper-small"]
RECURRENT_S = 80


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops (a launch a token in the scans): with the suite's
    workers sharing the cores, PyTorch's waiting intra-op threads cost more
    than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(name):
    cfg = pair(name)[2].cfg
    return counted_batch(cfg, s=RECURRENT_S if cfg.family in ("ssm", "hybrid") else 16)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_grads(name, _batch(name))


@pytest.mark.parametrize("name", ["rwkv6-3b", "hymba-1.5b", "whisper-small"])
def test_remat_policies_give_equal_bits(name):
    _, _, tm, tparams = pair(name)
    batch = _batch(name)
    runs = []
    for policy, remat in (("full", False), ("full", True), ("dots", True)):
        model = build_model(tm.cfg.replace(remat_policy=policy), device="cpu")
        runs.append(_value_and_grad(
            lambda p, b: lm_loss(model, p, b["tokens"], b["labels"], b.get("source"),
                                 remat=remat), tparams, batch))
    (loss0, grads0), rest = runs[0], runs[1:]
    for loss, grads in rest:
        assert torch.equal(loss, loss0)
        for (path, g), (_, g0) in zip(tree_items(grads), tree_items(grads0)):
            assert torch.equal(g, g0), path


def test_whisper_forward_is_encode_then_decoder():
    _, _, tm, tparams = pair("whisper-small")
    batch = _batch("whisper-small")
    with torch.no_grad():
        logits, aux = tm.forward(tparams, batch["tokens"], source=batch["source"])
        enc = tm.encode(tparams, batch["source"])
        want, _ = tm.decoder.forward(tparams["decoder"], batch["tokens"], source=enc)
    assert torch.equal(logits, want) and float(aux) == 0.0


# The scans as the port had them before their gradient form: the serving path's
# outputs must stay these bits.
def _old_wkv_scan(r, k, v, w, u, s0):
    b, s, h, n = r.shape
    t_major = lambda a: a.transpose(0, 1)
    r, k, v, w = map(t_major, (r, k, v, w))
    ys, state = [], s0
    for lo in range(0, s, 64):
        hi = min(s, lo + 64)
        kv = k[lo:hi, ..., :, None] * v[lo:hi, ..., None, :]
        states = torch.empty((hi - lo + 1, b, h, n, n), dtype=torch.float32)
        states[0] = state
        wt = w[lo:hi, ..., :, None]
        for t in range(hi - lo):
            torch.addcmul(kv[t], wt[t], states[t], out=states[t + 1])
        inner = torch.addcmul(states[:-1], u[:, :, None], kv)
        ys.append(torch.einsum("tbhn,tbhnm->tbhm", r[lo:hi], inner))
        state = states[-1]
    return torch.cat(ys).transpose(0, 1), state


def _old_ssm_scan(a, u, dt, bmat, cmat, h0):
    b, s, d_inner = u.shape
    n = a.shape[-1]
    t_major = lambda x: x.transpose(0, 1)
    u, dt, bmat, cmat = map(t_major, (u, dt, bmat, cmat))
    ys, h = [], h0
    for lo in range(0, s, 64):
        hi = min(s, lo + 64)
        dtb = dt[lo:hi]
        da = torch.exp(dtb[..., None] * a)
        dbx = (dtb * u[lo:hi])[..., None] * bmat[lo:hi, :, None, :]
        states = torch.empty((hi - lo + 1, b, d_inner, n), dtype=torch.float32)
        states[0] = h
        for t in range(hi - lo):
            torch.addcmul(dbx[t], da[t], states[t], out=states[t + 1])
        ys.append(torch.einsum("tbdn,tbn->tbd", states[1:], cmat[lo:hi]))
        h = states[-1]
    return torch.cat(ys).transpose(0, 1), h


def _scan_inputs(kind, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)
    if kind == "wkv":
        b, h, n = 2, 3, 8
        return (rnd(b, s, h, n), rnd(b, s, h, n), rnd(b, s, h, n),
                torch.rand((b, s, h, n), generator=g), rnd(h, n), rnd(b, h, n, n))
    b, d, n = 2, 12, 4
    return (-torch.rand((d, n), generator=g), rnd(b, s, d), torch.rand((b, s, d), generator=g),
            rnd(b, s, n), rnd(b, s, n), rnd(b, d, n))


@pytest.mark.parametrize("s", [1, 64, 130])
@pytest.mark.parametrize("kind", ["wkv", "ssm"])
def test_scans_serving_bits_unchanged_and_gradient_form_equal(kind, s):
    scan, old = ((rwkv6._wkv_scan, _old_wkv_scan) if kind == "wkv"
                 else (mamba._ssm_scan, _old_ssm_scan))
    args = _scan_inputs(kind, s)
    with torch.inference_mode():
        y_serve, st_serve = scan(*args)
        y_old, st_old = old(*args)
    assert torch.equal(y_serve, y_old) and torch.equal(st_serve, st_old)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, st = scan(*leaves)
    assert y.requires_grad
    assert torch.equal(y.detach(), y_serve) and torch.equal(st.detach(), st_serve)
    # and its gradient is that of the per-token recurrence written plainly
    (y.sum() + st.square().sum()).backward()
    plain = [a.clone().double().requires_grad_(True) for a in args]
    yp, sp = _plain_scan(kind, *plain)
    (yp.sum() + sp.square().sum()).backward()
    for got, want in zip(leaves, plain):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=1e-4, atol=1e-4)


def _plain_scan(kind, *args):
    """The recurrence token by token with no blocks (float64 here)."""
    if kind == "wkv":
        r, k, v, w, u, state = args
        ys = []
        for t in range(r.shape[1]):
            kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
            ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state + u[:, :, None] * kv))
            state = w[:, t, ..., :, None] * state + kv
        return torch.stack(ys, 1), state
    a, u, dt, bmat, cmat, h = args
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * u[:, t])[..., None] \
            * bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    return torch.stack(ys, 1), h
