#!/usr/bin/env python3
"""Where the port's bf16 backward first rounds differently from the JAX
reference's (CPU).

    PYTHONPATH=src python tools/bf16_grad_divergence.py [--arch llama2-7b] [--ops]

Runs the reference with ``XLA_FLAGS=--xla_allow_excess_precision=false``
(set here before JAX is imported), so that XLA rounds every bf16 op where
the reference's program rounds. Inputs: the reduced config with
``compute_dtype="bfloat16"``, the reference's PRNGKey(0) weights converted
for the port, and the counted batch of seed 0, step 0 (2 x 16 tokens).

1. *Layer by layer.* The training loss is taken apart at the layer
   boundaries: embedding, each self block, the head (final norm, unembed,
   cross entropy). Each side runs its own stages forward and pulls its own
   cotangent back stage by stage (``jax.vjp``; autograd on the port's
   ``_self_block``). Printed for the head's input and each layer's input:
   how many cotangent elements differ and by how much, relative to the
   largest.
2. *Op by op* (``--ops``): the first layer whose input cotangent differs
   while its output cotangent does not (else the top layer), its block
   split into ops (the norms, q/k/v with RoPE, the attention, the
   projections, the residual adds, the activation, the gating product). Both sides pull the
   *reference's* cotangent back through each op on the *reference's*
   inputs, so an op is measured alone: its input cotangents' differences
   are that op's backward rounding. The first op (in backward order) that
   differs is the divergence point.

Compares two packages, so it imports both; the port itself imports no JAX.
"""
from __future__ import annotations

import argparse
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_allow_excess_precision=false").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import attention as jattn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core import attention as tattn  # noqa: E402
from repro_torch.data.pipeline import batch_for_step  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

BF16 = "bfloat16"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, grad: bool = False) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 through f32,
    exactly)."""
    a = np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)
    t = torch.from_numpy(np.array(a))
    if x.dtype == jnp.bfloat16:
        t = t.to(torch.bfloat16)
    return t.requires_grad_(grad)


def differ(want, got) -> dict:
    """How ``got`` differs from ``want``: elements that differ, of all, and
    the largest difference relative to the largest |want|."""
    w, g = _np(want), _np(got)
    scale = max(float(np.abs(w).max()), 1e-30)
    return {"differ": int((w != g).sum()), "of": int(w.size),
            "max_rel": float(np.abs(w - g).max()) / scale}


def setup(arch: str):
    jcfg = jax_get_config(arch, reduced=True).replace(compute_dtype=BF16)
    tcfg = get_config(arch, reduced=True).replace(compute_dtype=BF16)
    if jcfg.n_experts or jcfg.family not in ("dense",):
        raise SystemExit(f"{arch}: dense configs only")
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    params = jm.init_params(jax.random.PRNGKey(0))
    tparams = from_jax(jax.tree.map(np.asarray, params), "cpu")
    batch = batch_for_step(jcfg.vocab_size, 16, 2, 0, 0)
    return jm, tm, params, tparams, batch


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def layer_cotangents(jm, tm, params, tparams, batch) -> list[tuple[str, dict]]:
    """Each side's own cotangent at the head's input and at each layer's
    input, pulled back stage by stage; returns (stage, differ) pairs from
    the top down, and the loss difference."""
    cfg = jm.cfg
    dt = jnp.bfloat16
    tok, lab = jnp.asarray(batch["tokens"].numpy()), jnp.asarray(batch["labels"].numpy())
    positions = jnp.arange(tok.shape[1])
    tpos = torch.arange(tok.shape[1])

    def jhead(x, p):
        logits = jm._unembed(p, jl.rms_norm(x, p["ln_f"], cfg.norm_eps))
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        iota = jax.lax.broadcasted_iota(jnp.int32, logits.shape, logits.ndim - 1)
        picked = jnp.sum(jnp.where(iota == lab[..., None], logits, 0.0), axis=-1)
        return jnp.mean(logz - picked)

    def thead(x, p):
        logits = tm._unembed(p, tl.rms_norm(x, p["ln_f"], cfg.norm_eps))
        picked = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        return torch.mean(torch.logsumexp(logits, dim=-1) - picked)

    jblock = jax.jit(lambda bp, x: jm._self_block(bp, x, positions, None, None)[0])
    xs = [params["embed"].astype(dt)[tok]]
    txs = [tparams["embed"].to(torch.bfloat16)[batch["tokens"]]]
    for i in range(cfg.n_layers):
        xs.append(jblock(_layer(params["blocks"], i), xs[-1]))
        with torch.no_grad():
            txs.append(tm._self_block(_layer(tparams["blocks"], i), txs[-1], tpos, None,
                                      None)[0])
    head = {k: params[k] for k in params if k != "blocks"}
    thead_p = {k: v for k, v in tparams.items() if k != "blocks"}
    loss, vjp = jax.vjp(lambda x: jhead(x, head), xs[-1])
    (g,) = vjp(jnp.ones((), jnp.float32))
    x = txs[-1].detach().requires_grad_(True)
    tloss = thead(x, thead_p)
    (tg,) = torch.autograd.grad(tloss, x)
    out = [("forward: the layers' outputs", {f"layer {i}": differ(xs[i + 1], txs[i + 1])
                                            for i in range(cfg.n_layers)}),
           ("loss", {"ref": float(loss), "port": float(tloss.detach())}),
           (f"cotangent at the head's input (layer {cfg.n_layers - 1}'s output)",
            differ(g, tg))]
    gs = [g]                          # the reference's cotangent at each layer's output
    first = None                      # the top layer whose input cotangent differs first
    same = out[-1][1]["differ"] == 0
    for i in reversed(range(cfg.n_layers)):
        _, vjp = jax.vjp(lambda x: jblock(_layer(params["blocks"], i), x), xs[i])
        (g,) = vjp(g)
        x = txs[i].detach().requires_grad_(True)
        y = tm._self_block(_layer(tparams["blocks"], i), x, tpos, None, None)[0]
        (tg,) = torch.autograd.grad(y, x, tg)
        out.append((f"cotangent at layer {i}'s input", differ(g, tg)))
        if same and out[-1][1]["differ"] and first is None:
            first = i
        same = same and out[-1][1]["differ"] == 0
        gs.append(g)
    gs = gs[::-1][1:]                 # gs[i]: at layer i's output
    return out, xs, gs, first


def block_ops(jm, tm, positions, tpos):
    """The self block of a dense config as (name, reference op, port op,
    input names, output name); params enter as inputs ``p/...``."""
    cfg = jm.cfg
    eps = cfg.norm_eps
    blk = cfg.attn_block or 512

    def jqkv(h, wq, wk, wv, *norms):
        p = {"wq": wq, "wk": wk, "wv": wv, **dict(zip(("qn", "kn"), norms))}
        return jm._qkv_rope(p, h, positions)

    def tqkv(h, wq, wk, wv, *norms):
        p = {"wq": wq, "wk": wk, "wv": wv, **dict(zip(("qn", "kn"), norms))}
        return tm._qkv_rope(p, h, tpos)

    norms = ("p/attn/qn", "p/attn/kn") if cfg.qk_norm else ()
    return [
        ("ln1 (rms_norm)", lambda x, w: jl.rms_norm(x, w, eps),
         lambda x, w: tl.rms_norm(x, w, eps), ("x", "p/ln1"), "h"),
        ("q/k/v projections + RoPE" + (" + qk_norm" if cfg.qk_norm else ""), jqkv, tqkv,
         ("h", "p/attn/wq", "p/attn/wk", "p/attn/wv", *norms), ("q", "k", "v")),
        ("attention (blockwise prefill)",
         lambda q, k, v: jattn.prefill_attention(q, k, v, causal=True, window=cfg.window,
                                                 kv_block=blk),
         lambda q, k, v: tattn.prefill_attention(q, k, v, causal=True, window=cfg.window,
                                                 kv_block=blk),
         ("q", "k", "v"), "a"),
        ("wo projection", lambda a, w: a.reshape(*a.shape[:2], -1) @ w.astype(a.dtype),
         lambda a, w: a.reshape(*a.shape[:2], -1) @ w.to(a.dtype), ("a", "p/attn/wo"), "o"),
        ("residual add 1", lambda x, o: x + o, lambda x, o: x + o, ("x", "o"), "x1"),
        ("ln2 (rms_norm)", lambda x, w: jl.rms_norm(x, w, eps),
         lambda x, w: tl.rms_norm(x, w, eps), ("x1", "p/ln2"), "h2"),
        ("up projection", lambda h, w: h @ w.astype(h.dtype), lambda h, w: h @ w.to(h.dtype),
         ("h2", "p/ffn/up"), "u"),
        ("gate projection", lambda h, w: h @ w.astype(h.dtype), lambda h, w: h @ w.to(h.dtype),
         ("h2", "p/ffn/gate"), "gt"),
        (f"activation ({cfg.act})", jl.act_fn(cfg.act), tl.act_fn(cfg.act), ("gt",), "s"),
        ("gating product", lambda s, u: s * u, lambda s, u: s * u, ("s", "u"), "m"),
        ("down projection", lambda m, w: m @ w.astype(m.dtype), lambda m, w: m @ w.to(m.dtype),
         ("m", "p/ffn/down"), "y"),
        ("residual add 2", lambda x, y: x + y, lambda x, y: x + y, ("x1", "y"), "out"),
    ]


def op_by_op(jm, tm, params, x, g_out, layer: int) -> list[tuple[str, dict]]:
    """Both sides' backward of each op of block ``layer`` alone, on the
    reference's inputs and incoming cotangent."""
    positions = jnp.arange(x.shape[1])
    tpos = torch.arange(x.shape[1])
    ops = block_ops(jm, tm, positions, tpos)
    env = {"x": x}
    for path, v in ((f"p/{k}", v) for k, v in _flat(_layer(params["blocks"], layer))):
        env[path] = v
    for _, jfn, _, ins, out in ops:
        res = jax.jit(jfn)(*(env[n] for n in ins))
        for name, val in zip((out,) if isinstance(out, str) else out,
                             (res,) if isinstance(out, str) else res):
            env[name] = val
    ct = {"out": g_out}
    report = []
    for name, jfn, tfn, ins, out in reversed(ops):
        outs = (out,) if isinstance(out, str) else out
        cts = tuple(ct[o] for o in outs)
        _, vjp = jax.vjp(jfn, *(env[n] for n in ins))
        jin = vjp(cts[0] if isinstance(out, str) else cts)
        targs = [_t(env[n], grad=True) for n in ins]
        tout = tfn(*targs)
        touts = (tout,) if isinstance(out, str) else tout
        tin = torch.autograd.grad(touts, targs, [_t(c) for c in cts], allow_unused=True)
        row = {}
        for n, jc, tc in zip(ins, jin, tin):
            row[f"d {n}"] = differ(jc, tc if tc is not None else torch.zeros(jc.shape))
            ct[n] = jc if n not in ct else ct[n] + jc
        report.append((name, row))
    return report


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--ops", action="store_true", help="also split the top layer into ops")
    args = ap.parse_args(argv)
    jm, tm, params, tparams, batch = setup(args.arch)
    rows, xs, gs, first = layer_cotangents(jm, tm, params, tparams, batch)
    print(f"{args.arch} reduced, bf16, XLA_FLAGS={os.environ['XLA_FLAGS']!r}")
    for name, d in rows:
        print(f"  {name}: {d}")
    if args.ops:
        layer = jm.cfg.n_layers - 1 if first is None else first
        print(f"  layer {layer} (the first whose input cotangent differs while its output's "
              "does not), op by op, backward order, on the reference's inputs and cotangents:")
        for name, row in op_by_op(jm, tm, params, xs[layer], gs[layer], layer):
            print(f"    {name}: {row}")


if __name__ == "__main__":
    main()
