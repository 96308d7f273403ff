"""Transformer LM: dense, MoE, RWKV6 (``ssm``), hybrid attention + Mamba
(``hybrid``) and cross-attention (``vlm``; whisper's decoder) stacks. Port
of ``repro.models.transformer``: the training ``forward`` (with
layer-boundary remat, :func:`make_remat`), and for serving lock-step
(``init_cache``, ``prefill``, ``decode_step``), the ragged forms of
continuous batching (``prefill_chunk``, ``prefill_chunks_batched``,
``finalize_slot``, ``release_slot``, ``decode_step(active=)``,
``decode_multi``), the source-KV pool (``ingest_source``,
``assign_source``, ``release_source``).

Decode (the paper's workload) keeps a KV cache ``[L, B, Smax, Hkv, Dh]``;
keys are cached post-RoPE (paper §IV-C) and the new token's q/k rotation
uses the incremental Eq. 11 recurrence carried in the cache
(``rope_mode="incremental"``) or direct cos/sin (``"direct"``).

Unlike the reference, whose arrays are immutable, every entry point updates
the cache dict's tensors in place and returns the same dict: a full-width
cache is gigabytes, and a copy per step would double the decode step's
memory traffic. The ragged forms take the slot, offset and last position
of a chunk as host ints (the engine knows them), so they read no device
value on the host; ``decode_multi`` runs its K ticks with no host
synchronization at all.

``cfg.decode_impl`` chooses the decode attention: ``kernel`` goes through
the hand-written kernel's wrapper (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors); ``tokenwise`` (the paper-literal per-token
recurrence), ``blockwise`` and ``naive`` run plain PyTorch on any device;
``sp`` folds each process's slice of the cache and merges the states over
the ``distributed.context``'s model axis (blockwise without a context, and
for int8, ring and cross reads). W4A8 projections choose by device alone
(``layers.linear``): on the GPU they always launch the GEMV kernel.

MoE configs (``family="moe"``) swap the MLP for ``models/moe.py``: the
capacity-factor dispatch in lock-step prefill (expert-parallel under a
``distributed.context``), drop-free dispatch (capacity = the chunk) in
chunked prefill, and the capacity-free per-row form at decode, as the
reference does.

Ring KV caches (``+ring`` sliding-window configs) keep ~window slots per
row whatever the context: position ``t`` lives in slot ``t mod R``, every
write lands there (a prompt longer than the ring keeps its last R tokens),
and decode reads the ring in place (``decode_attention(ring=True)``).

The recurrent families carry per-row state planes in the cache instead of,
or beside, the KV cache: an RWKV6 stack (``family="ssm"``, ``models/rwkv6.py``)
has no KV cache at all, only ``rwkv_att`` / ``rwkv_ffn`` [L, B, d] and
``rwkv_wkv`` [L, B, H, N, N]; a hybrid layer (``family="hybrid"``, hymba)
runs attention and a Mamba branch (``models/mamba.py``) side by side on the
same normed input and adds half of each, normed, to the residual, with the
Mamba state in ``mamba_conv`` / ``mamba_ssm``. An inactive row of a ragged
batch carries its state through unchanged, a chunk continues its slot's
state with the padded positions as exact no-ops, and a released slot's
state is zeroed.

Cross attention reads a source (stub frontend features ``[S_src, d]``)
through gated layers: ``tanh(gate) * wo(attention(wq(h), wk(src),
wv(src)))``, no RoPE on either side. llama-3.2-vision puts a dedicated
cross layer (cross attention, then an MLP) after every
``cross_attn_every - 1`` self layers (``params["cross_blocks"]``); whisper's
decoder (``cross_attn_every == 1``) has a cross attention inside every
layer (``ln_cross`` / ``cross``), between self attention and the MLP.
Lock-step serving keeps per-row source K/V ``cross_k`` / ``cross_v`` [Lc,
B, S_src, Hkv, Dh] with ``source_len`` [B], written by ``prefill``;
continuous serving keeps a pool ``src_k`` / ``src_v`` [Lc, E, S_src, Hkv,
Dh] of entries shared by the slots whose requests share a source, with
``src_len`` [E] and ``src_index`` [B]: written once per source by
``ingest_source``, read in place at decode (the kernel's ``entries=``
form). A cache with neither (no source) skips the cross term.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import attention as attn_lib
from repro_torch.core import prng
from repro_torch.core import rope as rope_lib
from repro_torch.core.quantization import quantize_kv
from repro_torch.core.swiftkv import dequantize_cache
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (constrain_batch_model, is_dtensor, local_chunk,
                                              merge_dims, replicate_where, replicated_value,
                                              shard_range, split_dim)
from . import mamba as mamba_lib
from . import moe as moe_lib
from . import rwkv6 as rwkv_lib
from .config import ModelConfig
from .layers import (batch_vocab_constrain, dense_init, embed_init, linear, mlp_apply,
                     mlp_init, rms_norm)

Params = dict
Cache = dict


def _put(plane: torch.Tensor, index, new: torch.Tensor,
         keep: torch.Tensor | None = None, mask_shape=None) -> None:
    """``plane[index] = new`` in the plane's dtype; with ``keep`` (a bool
    mask viewed as ``mask_shape``) only its true entries change and the
    others rewrite their old value — how a ring parks an inactive row's
    decode write and a chunk's padded tail. A ``DTensor`` plane is written
    on its local shard (:func:`_put_local`)."""
    if is_dtensor(plane):
        _put_local(plane, index, new, keep)
        return
    new = new.to(plane.dtype)
    if keep is not None:
        new = torch.where(keep.view(mask_shape), new, plane[index])
    plane[index] = new


def _put_local(plane, index, new: torch.Tensor, keep: torch.Tensor | None) -> None:
    """:func:`_put` on a ``DTensor`` plane whose ``index`` is ``(rows,
    [slice(None), ...], pos)``: row ``b`` of every row takes ``new[b]`` at
    position ``pos[b]`` of the last indexed dim. DTensor refuses an
    ``index_put_`` that would change a sharded plane's placements (a cache
    sharded over batch and sequence), so each process writes its own
    shard: its rows, at the positions its sequence slice holds (the others
    rewrite their old value), with ``new`` gathered over the dims the plane
    keeps whole. ``rows`` must be ``arange(B)``."""
    mesh, pls = plane.device_mesh, list(plane.placements)
    p = len(index) - 1
    rows_pl = [Shard(0) if pl.is_shard(0) else Replicate() for pl in pls]
    new_pl = [Shard(pl.dim - (pl.dim > p)) if pl.is_shard() and pl.dim != p else Replicate()
              for pl in pls]
    local = lambda t, want: local_chunk(replicated_value(t), want, mesh)
    new_l = (new.redistribute(mesh, new_pl).to_local() if is_dtensor(new)
             else local_chunk(new, new_pl, mesh))
    lo, size = shard_range(plane.shape[p], pls, mesh, p)
    pos = local(index[-1], rows_pl).long() - lo
    ok = (pos >= 0) & (pos < size)
    if keep is not None:
        ok = ok & local(keep, rows_pl)
    pl_local = plane.to_local()
    rows = torch.arange(pl_local.shape[0], device=pos.device)
    idx = (rows, *index[1:-1], pos.clamp(0, size - 1))
    old = pl_local[idx]
    pl_local[idx] = torch.where(ok.view(-1, *[1] * (old.dim() - 1)), new_l.to(old.dtype), old)


def _put_span(plane: torch.Tensor, slots, new: torch.Tensor) -> None:
    """``plane[:, slots] = new`` in the plane's dtype: a prompt's K/V into
    a cache plane [B, S, ...]. A ``DTensor`` plane is written on its local
    shard, as :func:`_put_local` writes: a slice of a sharded dim is a copy
    under DTensor, not a view, so a write into it would never reach the
    cache. Each process takes the positions of ``slots`` (a slice, or
    indices where the sequence is not sharded: a ring) that its sequence
    slice holds."""
    if not is_dtensor(plane):
        plane[:, slots] = new.to(plane.dtype)
        return
    mesh, pls = plane.device_mesh, list(plane.placements)
    new_pl = [pl if pl.is_shard() and pl.dim != 1 else Replicate() for pl in pls]
    new_l = (new.redistribute(mesh, new_pl).to_local() if is_dtensor(new)
             else local_chunk(new, new_pl, mesh)).to(plane.dtype)
    lo, size = shard_range(plane.shape[1], pls, mesh, 1)
    pl_local = plane.to_local()
    if not isinstance(slots, slice):
        if size != plane.shape[1]:
            raise NotImplementedError("a write at indices into a sequence-sharded cache")
        pl_local[:, slots] = new_l
        return
    start, stop, _ = slots.indices(plane.shape[1])
    a, b = max(start, lo), min(stop, lo + size)
    if b > a:
        pl_local[:, a - lo:b - lo] = new_l[:, a - start:b - start]


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: the embedding rows of ``tokens``. A ``DTensor``
    table is first gathered over its vocab dim (FSDP's gather): DTensor's
    lookup in a vocab-sharded table gives a masked partial sum, which the
    residual stream's next reduction refuses (and redistributing the
    lookup's output instead fails in backward). It then goes through
    ``F.embedding``, whose sharding rules (a batch-sharded index) DTensor
    implements, where indexing's gradient (an ``index_put`` with a sharded
    index) fails on torch 2.11; a plain table is indexed, the same rows."""
    if not is_dtensor(table):
        return table[tokens]
    return F.embedding(tokens, replicate_where(table, lambda i, pl: pl.is_shard(0)))


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` params tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked ``[L, ...]`` params tree, as views
    through one ``unbind`` per leaf: its backward stacks the layers'
    gradients once, where indexing each layer would make a full-size
    gradient of the stack per layer."""
    layers = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def make_remat(cfg: ModelConfig):
    """Layer-boundary rematerialization, as the reference's ``make_remat``:
    a wrapper that runs a layer function under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``. ``"full"``
    keeps only the layer's inputs and recomputes the rest in backward;
    ``"dots"`` also keeps the outputs of the products without batch dims
    (``aten.mm``: the projections; the batched attention and expert
    products are recomputed), as JAX's
    ``dots_with_no_batch_dims_saveable`` does."""
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, policy)
    return lambda f: functools.partial(checkpoint, f, **kw)


_RECURRENT_KEYS = ("rwkv_att", "rwkv_ffn", "rwkv_wkv", "mamba_conv", "mamba_ssm")


class TransformerLM:
    """Dense, MoE, RWKV6 (``ssm``), hybrid or vision cross-attention
    (``vlm``) LM, or a dense stack with a cross attention in every layer
    (whisper's decoder). ``causal=False, with_embedding=False`` makes the
    bidirectional encoder over ``embeds`` that ``forward`` runs (whisper's);
    the encoder-decoder itself is ``models/whisper.py``."""

    def __init__(self, cfg: ModelConfig, *,
                 device: str | torch.device | None = None,
                 causal: bool = True, with_embedding: bool = True):
        if cfg.family == "audio":
            raise NotImplementedError(
                f"{cfg.name}: family 'audio' is an encoder-decoder; build it with "
                "models.api.build_model (models/whisper.py)")
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported")
        if cfg.decode_impl not in ("kernel", "tokenwise", "blockwise", "naive", "sp"):
            raise NotImplementedError(
                f"decode_impl={cfg.decode_impl!r} is not one of "
                "kernel | tokenwise | blockwise | naive | sp")
        self.cfg = cfg
        self.causal = causal
        self.with_embedding = with_embedding
        self.device = resolve_device(device)

    @property
    def _dt(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    @property
    def _cross_impl(self) -> str:
        """The cross reads' decode attention: a source is not sharded over
        the sequence, so under ``sp`` they read blockwise, as in the
        reference."""
        return "blockwise" if self.cfg.decode_impl == "sp" else self.cfg.decode_impl

    @property
    def _ring(self) -> bool:
        return bool(self.cfg.kv_ring and self.cfg.window)

    def _n_cross_groups(self) -> int:
        """Dedicated cross layers (vision: one after every
        ``cross_attn_every - 1`` self layers), 0 otherwise."""
        cfg = self.cfg
        return cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every > 1 else 0

    def _n_cross_kv(self) -> int:
        """Layers that read a source: the dedicated cross layers, or every
        layer of a stack with an in-layer cross attention."""
        cfg = self.cfg
        if cfg.cross_attn_every > 1:
            return self._n_cross_groups()
        return cfg.n_layers if cfg.cross_attn_every == 1 else 0

    def _schedule(self) -> list[tuple[str, int]]:
        """The stack in order: ``("self", i)`` for self layer ``i`` (its
        index into ``blocks`` and the KV cache), ``("cross", g)`` for the
        dedicated cross layer ``g`` that follows each run of
        ``cross_attn_every - 1`` self layers."""
        n_cross = self._n_cross_groups()
        if not n_cross:
            return [("self", i) for i in range(self.cfg.n_layers)]
        per = self.cfg.cross_attn_every - 1
        order = []
        for g in range(n_cross):
            order += [("self", g * per + j) for j in range(per)] + [("cross", g)]
        return order

    # ---- init ------------------------------------------------------------
    def init_params(self, seed: int = 0, *,
                    dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on the
        model's device, in the reference's tree layout. ``dtype`` stores the
        embedding and projection matrices (float32 masters, like the
        reference, by default; the compute dtype halves a full-width
        model's memory); norm weights and the recurrent branches' small
        leaves (mix coefficients, decays, conv taps) stay float32."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        d, dh = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        n_cross = self._n_cross_groups()
        n_layers = cfg.n_layers - n_cross               # self layers
        ones = lambda *s: torch.ones(s, dtype=torch.float32, device=self.device)
        params: Params = {"ln_f": ones(d)}
        if self.with_embedding:
            params["embed"] = embed_init(gen, cfg.vocab_size, d, dtype=dtype)
            if not cfg.tie_embeddings:
                params["unembed"] = dense_init(gen, (d, cfg.vocab_size), dtype=dtype)
        if cfg.family == "ssm":
            params["blocks"] = {
                "ln1": ones(n_layers, d), "ln2": ones(n_layers, d),
                "mix": rwkv_lib.rwkv_layer_init(gen, (n_layers,), d, cfg.d_ff,
                                                cfg.rwkv_head_dim, dtype=dtype)}
            return params

        def attn_init(n: int, cross: bool = False) -> Params:
            p = {"wq": dense_init(gen, (n, d, hq * dh), dtype=dtype),
                 "wk": dense_init(gen, (n, d, hkv * dh), dtype=dtype),
                 "wv": dense_init(gen, (n, d, hkv * dh), dtype=dtype),
                 "wo": dense_init(gen, (n, hq * dh, d), dtype=dtype)}
            if cfg.qk_norm:
                p["qn"] = ones(n, dh)
                p["kn"] = ones(n, dh)
            if cross:       # the cross term's gate, 0 at init as in the reference
                p["gate"] = torch.zeros(n, dtype=torch.float32, device=self.device)
            return p

        attn = attn_init(n_layers)
        if cfg.n_experts:
            ffn = moe_lib.moe_init(gen, (n_layers,), d, cfg.d_ff, cfg.n_experts,
                                   cfg.gated_mlp, dtype=dtype)
        else:
            ffn = mlp_init(gen, (n_layers,), d, cfg.d_ff, cfg.gated_mlp, dtype=dtype)
        params["blocks"] = {
            "ln1": ones(n_layers, d), "attn": attn, "ln2": ones(n_layers, d),
            "ffn": ffn}
        if cfg.family == "hybrid":
            params["blocks"].update(
                mamba=mamba_lib.mamba_init(gen, (n_layers,), d, state=cfg.ssm_state,
                                           conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                                           dtype=dtype),
                ln_attn_out=ones(n_layers, d), ln_mamba_out=ones(n_layers, d))
        if cfg.cross_attn_every == 1:       # whisper's decoder: cross inside the layer
            params["blocks"].update(ln_cross=ones(n_layers, d),
                                    cross=attn_init(n_layers, cross=True))
        if n_cross:                         # vision: dedicated cross layers
            params["cross_blocks"] = {
                "ln1": ones(n_cross, d), "cross": attn_init(n_cross, cross=True),
                "ln2": ones(n_cross, d),
                "ffn": mlp_init(gen, (n_cross,), d, cfg.d_ff, cfg.gated_mlp, dtype=dtype)}
        return params

    def _mix_branches(self, bp: Params, attn_out: torch.Tensor,
                      mamba_out: torch.Tensor) -> torch.Tensor:
        """A hybrid layer's residual update: half of each branch, normed."""
        eps = self.cfg.norm_eps
        return 0.5 * (rms_norm(attn_out, bp["ln_attn_out"], eps)
                      + rms_norm(mamba_out, bp["ln_mamba_out"], eps))

    def _ffn(self, p: Params, h: torch.Tensor,
             capacity: int | None = None) -> torch.Tensor:
        """The block's MLP, or on an MoE config its experts: a decode batch
        ``[B, d]`` through the capacity-free per-row form, a sequence
        ``[B, S, d]`` through the capacity dispatch (``capacity``, or the
        config's capacity factor)."""
        cfg = self.cfg
        if not cfg.n_experts:
            return mlp_apply(p, h, cfg.act, cfg.gated_mlp)
        kw = {"top_k": cfg.top_k, "act": cfg.act, "gated": cfg.gated_mlp}
        if h.dim() == 2:
            return moe_lib.moe_apply_rowwise(p, h, **kw)[0]
        return moe_lib.moe_apply(p, h, capacity_factor=cfg.capacity_factor,
                                 capacity=capacity, **kw)[0]

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if not self.with_embedding:         # an encoder: the normed hidden states
            return x
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        # pin (batch over DP, vocab over model): see layers.batch_vocab_constrain
        return batch_vocab_constrain((x @ w.to(x.dtype)).float())

    # ---- cross attention ---------------------------------------------------
    def _gated(self, p: Params, out: torch.Tensor) -> torch.Tensor:
        """A cross term: ``tanh(gate) * out``, the gate taken in float32 and
        cast to the output's dtype, as the reference does."""
        return torch.tanh(p["gate"]).to(out.dtype) * out

    def _source_kv(self, p: Params, src: torch.Tensor):
        """A cross layer's K/V of source rows ``src`` [..., S, d] -> [..., S,
        Hkv, Dh] each (no RoPE: cross keys are position-free)."""
        cfg = self.cfg
        heads = (cfg.n_kv_heads, cfg.resolved_head_dim)
        k = split_dim(linear(p, "wk", src), -1, heads)
        v = split_dim(linear(p, "wv", src), -1, heads)
        if cfg.qk_norm:
            k = rms_norm(k, p["kn"], cfg.norm_eps)
        return k, v

    def _cross_query(self, p: Params, h: torch.Tensor, qk_norm: bool = True) -> torch.Tensor:
        """wq of ``h`` [..., d] -> [..., Hq, Dh], q-normed on a qk-norm
        config unless ``qk_norm`` is false (the reference's lock-step
        prefill of a vision cross layer skips it)."""
        cfg = self.cfg
        q = split_dim(linear(p, "wq", h), -1, (cfg.n_heads, cfg.resolved_head_dim))
        if qk_norm and cfg.qk_norm:
            q = rms_norm(q, p["qn"], cfg.norm_eps)
        return q

    def _cross_seq(self, p: Params, h: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_lengths: torch.Tensor | None = None,
                   qk_norm: bool = True) -> torch.Tensor:
        """A sequence's gated cross term: queries of ``h`` [B, S, d]
        against source K/V [B, S_src, Hkv, Dh], non-causal, masked to
        ``kv_lengths``."""
        q = self._cross_query(p, h, qk_norm)
        out = attn_lib.prefill_attention(q, k, v, causal=False, kv_lengths=kv_lengths,
                                         kv_block=self.cfg.attn_block or 512)
        return self._gated(p, linear(p, "wo", merge_dims(out, 2)))

    # ---- forward (whole sequences: training, and the whisper encoder) -------
    def forward(self, params: Params, tokens: torch.Tensor | None = None, *,
                embeds: torch.Tensor | None = None,
                source: torch.Tensor | None = None,
                kv_length: torch.Tensor | None = None,
                remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """Whole sequences through the stack: ``tokens`` [B, S] or
        ``embeds`` [B, S, d] -> (logits [B, S, V] f32, or the normed hidden
        states when the model has no embedding: an encoder; the MoE
        load-balance loss summed over the layers, [] f32, 0 without
        experts). ``source`` [B, S_src, d]: the cross layers' source.
        ``kv_length`` [B]: each row's valid prefix; keys past it are
        masked, so a padded row's valid positions do not depend on the
        padding. Self attention is causal unless the model was built
        ``causal=False``. The reference's training ``forward``.

        ``remat``: while autograd records, each layer (on a vision stack,
        also each group of self layers and the cross layer after them) is
        rematerialized in backward under ``cfg.remat_policy``
        (:func:`make_remat`); it changes no value."""
        cfg = self.cfg
        x = self._embed(params, tokens) if embeds is None else embeds.to(self._dt)
        positions = torch.arange(x.shape[1], device=x.device)
        wrap = make_remat(cfg) if remat and torch.is_grad_enabled() else (lambda f: f)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n_cross = self._n_cross_groups()
        if cfg.family == "ssm":
            step = wrap(self._rwkv_block)
            for bp in _unstack(params["blocks"], cfg.n_layers):
                x = step(bp, x)
        else:
            blocks = _unstack(params["blocks"], cfg.n_layers - n_cross)
            step = wrap(self._self_block)
            if not n_cross:
                for bp in blocks:
                    x, a = step(bp, x, positions, source, kv_length)
                    aux = aux + a
            else:
                per = cfg.cross_attn_every - 1

                def group(sps, cp, x, aux):
                    for bp in sps:
                        x, a = step(bp, x, positions, source, kv_length)
                        aux = aux + a
                    return self._cross_block(cp, x, source), aux

                group = wrap(group)
                for g, cp in enumerate(_unstack(params["cross_blocks"], n_cross)):
                    x, aux = group(blocks[g * per:(g + 1) * per], cp, x, aux)
        return self._unembed(params, self._norm_in(x, params["ln_f"])), aux

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings [B, S, d] in the compute dtype (the table cast
        first, so ``bf16_gather``'s gather moves the compute dtype)."""
        return _lookup(params["embed"].to(self._dt), tokens)

    def _ffn_out(self, bp: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """ln2 and the block's MLP (or its experts, with the capacity
        factor) over a sequence: (y, the MoE load-balance loss)."""
        cfg = self.cfg
        h2 = self._norm_in(x, bp["ln2"])
        if cfg.n_experts:
            return moe_lib.moe_apply(bp["ffn"], h2, top_k=cfg.top_k, act=cfg.act,
                                     gated=cfg.gated_mlp, capacity_factor=cfg.capacity_factor)
        return (mlp_apply(bp["ffn"], h2, cfg.act, cfg.gated_mlp),
                torch.zeros((), dtype=torch.float32, device=x.device))

    @staticmethod
    def _seq_shard(x: torch.Tensor) -> torch.Tensor:
        """Megatron-style sequence-sharded residual stream: a [B, S, d]
        ``DTensor`` between blocks pinned to (batch over the batch axes, S
        over the model axis), each where it divides the dim, so the
        row-parallel partial sums reduce-scatter before the norms and
        all-gather before the next product. A no-op outside a distribution
        context, on a plain tensor and on one position."""
        if x.dim() != 3 or x.shape[1] == 1:
            return x
        return constrain_batch_model(x, 1)

    def _norm_in(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """``rms_norm`` of the residual stream where a block reads it; on a
        ``DTensor`` the result is then gathered to (batch over the batch
        axes, the rest replicated): the all-gather half of
        :meth:`_seq_shard`'s pattern, where the norm runs on each process's
        positions and the products on the whole sequence (GSPMD places the
        same gather; left to DTensor, the products would see a strided
        shard of the flattened batch and sequence)."""
        return constrain_batch_model(rms_norm(x, weight, self.cfg.norm_eps), None)

    def _self_block(self, bp: Params, x: torch.Tensor, positions: torch.Tensor,
                    source: torch.Tensor | None, kv_length: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One self layer over whole sequences: attention (beside the Mamba
        branch on a hybrid stack), whisper's in-layer cross attention,
        then the MLP or experts. Returns (x, the layer's MoE loss)."""
        cfg = self.cfg
        h = self._norm_in(x, bp["ln1"])
        q, k, v = self._qkv_rope(bp["attn"], h, positions)
        a = attn_lib.prefill_attention(q, k, v, causal=self.causal, window=cfg.window,
                                       kv_lengths=kv_length, kv_block=cfg.attn_block or 512)
        attn_out = linear(bp["attn"], "wo", merge_dims(a, 2))
        if cfg.family == "hybrid":
            x = x + self._mix_branches(bp, attn_out, mamba_lib.mamba_forward(bp["mamba"], h))
        else:
            x = x + attn_out
        if "cross" in bp and source is not None:
            k, v = self._source_kv(bp["cross"], source)
            x = x + self._cross_seq(bp["cross"], self._norm_in(x, bp["ln_cross"]), k, v)
        y, aux = self._ffn_out(bp, x)
        return self._seq_shard(x + y), aux

    def _cross_block(self, cp: Params, x: torch.Tensor,
                     source: torch.Tensor | None) -> torch.Tensor:
        """A vision stack's dedicated cross layer: the gated cross term
        (skipped without a source), then its MLP."""
        cfg = self.cfg
        if source is not None:
            k, v = self._source_kv(cp["cross"], source)
            x = x + self._cross_seq(cp["cross"], self._norm_in(x, cp["ln1"]), k, v)
        return self._seq_shard(
            x + mlp_apply(cp["ffn"], self._norm_in(x, cp["ln2"]), cfg.act, cfg.gated_mlp))

    def _rwkv_block(self, bp: Params, x: torch.Tensor) -> torch.Tensor:
        """One RWKV6 layer over whole sequences, from zero states (the
        reference's ``_rwkv_forward`` step)."""
        cfg = self.cfg
        b, d = x.shape[0], cfg.d_model
        st = rwkv_lib.RWKVLayerState(
            x_prev_att=x.new_zeros((b, d)), x_prev_ffn=x.new_zeros((b, d)),
            wkv=torch.zeros((b, d // cfg.rwkv_head_dim, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                            dtype=torch.float32, device=x.device))
        y, st = rwkv_lib.rwkv_time_mix(bp["mix"], rms_norm(x, bp["ln1"], cfg.norm_eps), st,
                                       cfg.rwkv_head_dim)
        x = x + y
        y2, _ = rwkv_lib.rwkv_channel_mix(bp["mix"], rms_norm(x, bp["ln2"], cfg.norm_eps), st)
        return x + y2

    # ---- KV cache ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, source_len: int | None = None, *,
                   n_sources: int | None = None, chunk: int | None = None,
                   kv_dtype: torch.dtype | None = None) -> Cache:
        """Preallocated decode state: KV tensors [L, B, Smax, Hkv, Dh] in
        the KV storage dtype (int8 for ``+w4a8`` configs, else the compute
        dtype), per-row lengths, and the incremental-RoPE angle state.

        An int8 cache adds bf16 dequant scales ``k_scale``/``v_scale``
        [L, B, Hkv, Smax] (position last). For ``decode_impl="kernel"``
        ``max_len`` rounds up to a multiple of 128 (of 8 for caches of at
        most 128), as the reference does for its TPU kernel, so cache
        shapes compare one to one; the CUDA kernel itself needs no
        alignment.

        A ring cache (``+ring``) has ``min(max_len, round128(window +
        (chunk or 1)))`` slots: decode needs R >= window + 1 (a write may
        only evict the position leaving the window), chunked prefill R >=
        window + chunk - 1 (a chunk's later tokens may only overwrite
        positions outside its earlier queries' windows), so ``chunk`` (the
        serving engine's prefill chunk) makes the bound hold by
        construction.

        An RWKV6 stack has no KV cache: its cache is the lengths and the
        state planes ``rwkv_att`` / ``rwkv_ffn`` [L, B, d] (compute dtype)
        and ``rwkv_wkv`` [L, B, H, N, N] (float32). A hybrid config adds
        the Mamba planes ``mamba_conv`` [L, B, K-1, d_inner] and
        ``mamba_ssm`` [L, B, d_inner, N] (float32) to its KV cache.

        A stack that reads a source (Lc cross layers) adds, with
        ``source_len`` alone (lock-step), per-row ``cross_k`` / ``cross_v``
        [Lc, B, S_src, Hkv, Dh] in the compute dtype and ``source_len`` [B]
        (S_src until ``prefill`` writes the rows' own); with ``n_sources``
        too (continuous), the pool ``src_k`` / ``src_v`` [Lc, E, S_src,
        Hkv, Dh] in the KV dtype (with bf16 ``src_k_scale`` /
        ``src_v_scale`` [Lc, E, Hkv, S_src] when int8), ``src_len`` [E] and
        ``src_index`` [B]. The self KV planes have one layer per self
        layer (L minus the dedicated cross layers)."""
        cfg = self.cfg
        dh = cfg.resolved_head_dim
        dev = self.device
        lens = torch.zeros((batch,), dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        if cfg.family == "ssm":
            h = cfg.d_model // cfg.rwkv_head_dim
            plane = (cfg.n_layers, batch, cfg.d_model)
            return {"len": lens,
                    "rwkv_att": torch.zeros(plane, dtype=self._dt, device=dev),
                    "rwkv_ffn": torch.zeros(plane, dtype=self._dt, device=dev),
                    "rwkv_wkv": torch.zeros((cfg.n_layers, batch, h, cfg.rwkv_head_dim,
                                             cfg.rwkv_head_dim), **f32)}
        kv_len = max_len
        if self._ring:
            want = cfg.window + (chunk if chunk else 1)
            kv_len = min(max_len, -(-want // 128) * 128)
        if cfg.decode_impl == "kernel":
            mult = 128 if kv_len > 128 else 8
            kv_len = -(-kv_len // mult) * mult
        kv_dt = kv_dtype or (torch.int8 if cfg.w4a8_serve else self._dt)
        n_self = cfg.n_layers - self._n_cross_groups()
        cache: Cache = {"len": lens}
        shape = (n_self, batch, kv_len, cfg.n_kv_heads, dh)
        cache["k"] = torch.zeros(shape, dtype=kv_dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=kv_dt, device=dev)
        if kv_dt == torch.int8:
            sshape = (n_self, batch, cfg.n_kv_heads, kv_len)
            cache["k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=dev)
            cache["v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=dev)
        if cfg.rotary_dim:
            self._reset_rope(cache, 0)
        if cfg.family == "hybrid":
            d_inner = cfg.ssm_expand * cfg.d_model
            cache["mamba_conv"] = torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_conv - 1, d_inner), **f32)
            cache["mamba_ssm"] = torch.zeros((cfg.n_layers, batch, d_inner, cfg.ssm_state),
                                             **f32)
        n_cross_kv = self._n_cross_kv()
        i32 = dict(dtype=torch.int32, device=dev)
        if n_cross_kv and source_len and n_sources:
            pool = (n_cross_kv, n_sources, source_len, cfg.n_kv_heads, dh)
            cache["src_k"] = torch.zeros(pool, dtype=kv_dt, device=dev)
            cache["src_v"] = torch.zeros(pool, dtype=kv_dt, device=dev)
            cache["src_len"] = torch.zeros((n_sources,), **i32)
            cache["src_index"] = torch.zeros((batch,), **i32)
            if kv_dt == torch.int8:
                sshape = (n_cross_kv, n_sources, cfg.n_kv_heads, source_len)
                cache["src_k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=dev)
                cache["src_v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=dev)
        elif n_cross_kv and source_len:
            rows = (n_cross_kv, batch, source_len, cfg.n_kv_heads, dh)
            cache["cross_k"] = torch.zeros(rows, dtype=self._dt, device=dev)
            cache["cross_v"] = torch.zeros(rows, dtype=self._dt, device=dev)
            cache["source_len"] = torch.full((batch,), source_len, **i32)
        return cache

    def _reset_rope(self, cache: Cache, position: int) -> None:
        cfg = self.cfg
        rs = rope_lib.rope_state_init(cfg.resolved_head_dim, cfg.rope_base,
                                      position, cfg.rotary_dim, device=self.device)
        b = cache["len"].shape[0]
        cache["rope_cos"] = rs.cos_m.expand(b, -1).clone()
        cache["rope_sin"] = rs.sin_m.expand(b, -1).clone()

    def _rope_qk_decode(self, cache: Cache, q: torch.Tensor, k: torch.Tensor):
        """Rotate the new token's q/k ([B, H, Dh]) at its absolute position."""
        cfg = self.cfg
        if not cfg.rotary_dim:
            return q, k
        if cfg.rope_mode == "incremental":
            cos, sin = cache["rope_cos"], cache["rope_sin"]           # [B, rd/2]
            rd = 2 * cos.shape[-1]

            def rot(x):
                xr, xp = x[..., :rd], x[..., rd:]
                x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
                c, s = cos[:, None, :].to(x.dtype), sin[:, None, :].to(x.dtype)
                return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c, xp], dim=-1)
            return rot(q), rot(k)
        pos = cache["len"][:, None, None]                             # [B, 1, 1]
        rot = lambda x: rope_lib.apply_rope(x[:, :, None, :], pos, cfg.rope_base,
                                            cfg.rotary_dim)[:, :, 0, :]
        return rot(q), rot(k)

    def _advance_rope(self, cache: Cache) -> None:
        cfg = self.cfg
        if cfg.rotary_dim and cfg.rope_mode == "incremental":
            freqs = rope_lib.rope_freqs(cfg.resolved_head_dim, cfg.rope_base,
                                        cfg.rotary_dim, device=self.device)
            rs = rope_lib.rope_state_advance(rope_lib.RopeState(
                cos_m=cache["rope_cos"], sin_m=cache["rope_sin"],
                a=torch.cos(freqs), b=torch.sin(freqs)))
            cache["rope_cos"], cache["rope_sin"] = rs.cos_m, rs.sin_m

    # ---- decode -------------------------------------------------------------
    def _decode_self_attn(self, p: Params, h: torch.Tensor, layer: int,
                          cache: Cache, active: torch.Tensor | None = None
                          ) -> torch.Tensor:
        cfg = self.cfg
        b = h.shape[0]
        dh = cfg.resolved_head_dim
        q = split_dim(linear(p, "wq", h), -1, (cfg.n_heads, dh))
        k = split_dim(linear(p, "wk", h), -1, (cfg.n_kv_heads, dh))
        v = split_dim(linear(p, "wv", h), -1, (cfg.n_kv_heads, dh))
        if cfg.qk_norm:
            q = rms_norm(q, p["qn"], cfg.norm_eps)
            k = rms_norm(k, p["kn"], cfg.norm_eps)
        q, k = self._rope_qk_decode(cache, q, k)
        kc, vc = cache["k"][layer], cache["v"][layer]                 # [B, S, Hkv, Dh]
        rows = torch.arange(b, device=h.device)
        lengths = cache["len"]
        keep = None
        if active is None:
            pos, attn_len = lengths.long() % kc.shape[1], lengths + 1
        elif self._ring:
            # ragged ring batch: a ring has no dead row to park on (every
            # slot is, or wraps into, a live window position), so an
            # inactive row rewrites its slot's old value (a per-row write
            # mask) and attends a 1-token stub
            pos = lengths.long() % kc.shape[1]
            attn_len = torch.where(active, lengths + 1, 1)
            keep = active
        else:
            # ragged batch: inactive rows (free or mid-prefill slots) park
            # their discarded write on the reserved tail row and attend a
            # 1-token stub, so the batch keeps its shape while slot
            # membership changes (serving/slot_pool.py reserves the tail)
            pos = torch.where(active, lengths, kc.shape[1] - 1).long()
            attn_len = torch.where(active, lengths + 1, 1)
        ksc = vsc = None
        if "k_scale" in cache:
            # int8 cache: quantize the new token's K/V over Dh per head;
            # the scale plane parks with the row
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            ksc, vsc = cache["k_scale"][layer], cache["v_scale"][layer]  # [B, Hkv, S]
            _put(ksc, (rows, slice(None), pos), k_s, keep, (b, 1))
            _put(vsc, (rows, slice(None), pos), v_s, keep, (b, 1))
        _put(kc, (rows, pos), k, keep, (b, 1, 1))
        _put(vc, (rows, pos), v, keep, (b, 1, 1))
        out = attn_lib.decode_attention(q, kc, vc, attn_len,
                                        impl=cfg.decode_impl, window=cfg.window,
                                        ring=self._ring,
                                        block_size=cfg.attn_block or 512,
                                        k_scale=ksc, v_scale=vsc)
        return linear(p, "wo", merge_dims(out, 1))

    def _decode_cross_attn(self, p: Params, h: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, source_len: torch.Tensor) -> torch.Tensor:
        """Per-row (lock-step) cross read: ck/cv [B, S_src, Hkv, Dh] written
        by :meth:`prefill`, each row masked to its ``source_len``; the
        decode attention of ``cfg.decode_impl`` (the kernel's linear form on
        ``kernel``)."""
        out = attn_lib.decode_attention(self._cross_query(p, h), ck, cv, source_len,
                                        impl=self._cross_impl,
                                        block_size=self.cfg.attn_block or 512)
        return self._gated(p, linear(p, "wo", merge_dims(out, 1)))

    def _decode_cross_attn_pooled(self, p: Params, h: torch.Tensor, sk: torch.Tensor,
                                  sv: torch.Tensor, entries: torch.Tensor,
                                  src_len: torch.Tensor, sk_sc: torch.Tensor | None = None,
                                  sv_sc: torch.Tensor | None = None) -> torch.Tensor:
        """Pooled (continuous) cross read: sk/sv are one layer's pool [E,
        S_src, Hkv, Dh], each row reads entry ``entries[b]`` up to that
        entry's ``src_len`` (gathered on the device), in place, by
        ``attn_lib.decode_cross_attention`` (``kernel``: the kernel's
        ``entries=`` form, where the reference has no pooled kernel and
        reads blockwise). A row whose entry has ``src_len == 0`` reads an
        exact 0."""
        b = h.shape[0]
        out = attn_lib.decode_cross_attention(
            self._cross_query(p, h), sk, sv, entries, src_len[entries.long()],
            impl=self._cross_impl, block_size=self.cfg.attn_block or 512,
            k_scale=sk_sc, v_scale=sv_sc)
        return self._gated(p, linear(p, "wo", out.reshape(b, -1)))

    def _decode_cross(self, p: Params, h: torch.Tensor, j: int,
                      cache: Cache) -> torch.Tensor | None:
        """Cross layer ``j``'s gated term at decode: the pool's read, the
        per-row read, or None when the cache holds no source."""
        if "src_k" in cache:
            scales = ((cache["src_k_scale"][j], cache["src_v_scale"][j])
                      if "src_k_scale" in cache else (None, None))
            return self._decode_cross_attn_pooled(p, h, cache["src_k"][j], cache["src_v"][j],
                                                  cache["src_index"], cache["src_len"],
                                                  *scales)
        if "cross_k" in cache:
            return self._decode_cross_attn(p, h, cache["cross_k"][j], cache["cross_v"][j],
                                           cache["source_len"])
        return None

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Cache,
                    active: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, Cache]:
        """tokens: [B] int -> (logits [B, V] f32, the cache updated in place).

        ``active``: optional [B] bool, the ragged continuous-batching form.
        Active rows decode normally; inactive rows ride through with a
        parked KV write, a stub attention length and no ``len`` advance.
        The incremental-RoPE state advances for every row, as in the
        reference; ``finalize_slot`` reseeds a slot's state when a new
        request fills it.

        Recurrent state (RWKV6's planes, a hybrid layer's Mamba state) has
        no parking row, the row is the state: an inactive row carries it
        through unchanged.

        Cross reads are read-only (nothing to park): an inactive row's
        read is discarded with its output."""
        cfg = self.cfg
        x = _lookup(params["embed"], tokens).to(self._dt)               # [B, d]
        if cfg.family == "ssm":
            return self._rwkv_decode_step(params, x, cache, active)
        blocks = params["blocks"]
        eps = cfg.norm_eps
        for kind, i in self._schedule():
            if kind == "cross":                                        # vision's cross layer
                cp = _layer(params["cross_blocks"], i)
                c = self._decode_cross(cp["cross"], rms_norm(x, cp["ln1"], eps), i, cache)
                if c is not None:
                    x = x + c
                x = x + mlp_apply(cp["ffn"], rms_norm(x, cp["ln2"], eps), cfg.act,
                                  cfg.gated_mlp)
                continue
            bp = _layer(blocks, i)
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            attn_out = self._decode_self_attn(bp["attn"], h, i, cache, active)
            if cfg.family == "hybrid":
                st = mamba_lib.MambaState(cache["mamba_conv"][i], cache["mamba_ssm"][i])
                m_out, st = mamba_lib.mamba_decode_step(bp["mamba"], h, st, active=active)
                cache["mamba_conv"][i], cache["mamba_ssm"][i] = st.conv, st.ssm
                x = x + self._mix_branches(bp, attn_out, m_out)
            else:
                x = x + attn_out
            if "cross" in bp:                                          # whisper's decoder
                c = self._decode_cross(bp["cross"], rms_norm(x, bp["ln_cross"], eps), i, cache)
                if c is not None:
                    x = x + c
            h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            x = x + self._ffn(bp["ffn"], h2)
        cache["len"] += 1 if active is None else active.to(torch.int32)
        self._advance_rope(cache)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._unembed(params, x), cache

    # ---- multi-tick decode: K ticks, one host sync -------------------------
    def decode_multi(self, params: Params, tok: torch.Tensor, cache: Cache,
                     active: torch.Tensor, budget: torch.Tensor,
                     serials: torch.Tensor, emitted: torch.Tensor,
                     n_ticks: int, *, eos_id: int | None = None,
                     temperature: float = 0.0,
                     base_key: torch.Tensor | None = None,
                     poison: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, Cache]:
        """``n_ticks`` ragged decode ticks with sampling and retirement on
        the device: the reference's ``lax.scan`` over ``decode_step(active=)``
        as a Python loop that reads no device value, so the caller syncs
        once per block, on the token block.

        Per tick, each active row decodes, picks its next token (greedy
        argmax when ``temperature == 0``, else :func:`prng.seeded_gumbel_pick`
        keyed on ``(base_key, serial, token index)``), advances ``emitted``,
        and retires itself when the token is ``eos_id`` or ``emitted``
        reaches ``budget``; from the next tick it parks like any inactive
        row. A retired row's last token is emitted but not fed back.

        tok/serials/emitted/budget: [B] int32; active: [B] bool. Returns
        ``(tok_block [K, B] int32, active, emitted, cache)``: the token
        row ``b`` emitted at tick ``t``, ``-1`` if the row was inactive, or
        ``-2`` if its logits were not finite (the row then retires with
        ``emitted`` unchanged).

        ``poison``: optional [B] bool fault-injection mask
        (:mod:`repro_torch.serving.faults`): the masked rows' logits become
        NaN each tick, before the finite check, so the ``-2`` sentinel
        fires on the device. ``None`` adds no operation."""
        if temperature != 0.0 and base_key is None:
            base_key = prng.prng_key(0, device=tok.device)
        outs = []
        for _ in range(n_ticks):
            logits, cache = self.decode_step(params, tok, cache, active)
            if poison is not None:
                logits = torch.where(poison[:, None], torch.nan, logits)
            finite = torch.isfinite(logits).all(dim=-1)
            if temperature == 0.0:
                pick = logits.argmax(dim=-1).to(torch.int32)
            else:
                pick = prng.seeded_gumbel_pick(base_key, logits, serials, emitted,
                                               temperature)
            ok = active & finite
            emitted = torch.where(ok, emitted + 1, emitted)
            done = emitted >= budget
            if eos_id is not None:
                done |= pick == eos_id
            outs.append(torch.where(active, torch.where(finite, pick, -2), -1)
                        .to(torch.int32))
            active = ok & ~done
            tok = torch.where(active, pick, tok)
        return torch.stack(outs), active, emitted, cache

    # ---- prefill ------------------------------------------------------------
    def _qkv_rope(self, p: Params, h: torch.Tensor, positions: torch.Tensor):
        """Projections, qk-norm and direct RoPE of a [B, S, d] sequence at
        ``positions`` [S] -> q [B, S, Hq, Dh], k and v [B, S, Hkv, Dh]
        (keys leave here post-RoPE)."""
        cfg = self.cfg
        dh = cfg.resolved_head_dim
        q = split_dim(linear(p, "wq", h), -1, (cfg.n_heads, dh))
        k = split_dim(linear(p, "wk", h), -1, (cfg.n_kv_heads, dh))
        v = split_dim(linear(p, "wv", h), -1, (cfg.n_kv_heads, dh))
        if cfg.qk_norm:
            q = rms_norm(q, p["qn"], cfg.norm_eps)
            k = rms_norm(k, p["kn"], cfg.norm_eps)
        if cfg.rotary_dim:
            rope = lambda t: rope_lib.apply_rope(t.transpose(1, 2), positions,
                                                 cfg.rope_base,
                                                 cfg.rotary_dim).transpose(1, 2)
            q, k = rope(q), rope(k)
        return q, k, v

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Cache,
                source: torch.Tensor | None = None,
                source_len: torch.Tensor | None = None) -> tuple[torch.Tensor, Cache]:
        """tokens: [B, Sp] (uniform prompt length) -> (last-position logits
        [B, V] f32, the cache filled in place). Keys are cached post-RoPE.
        An int8 cache stores quantized K/V, but attention here consumes the
        fresh float K/V, as in the reference. A ring cache of R < Sp slots
        keeps the last R tokens, each at slot ``pos % R``.

        ``source`` [B, S_src, d]: the cross layers' source (needs a cache
        made with ``source_len``), its K/V written to ``cross_k`` /
        ``cross_v``; ``source_len`` [B]: each row's valid source prefix
        (default S_src), masking the padded tail here and, through
        ``cache["source_len"]``, at decode. ``source=None`` means no
        source: the gated cross term is skipped, while a dedicated cross
        layer still applies its MLP."""
        cfg = self.cfg
        b, sp = tokens.shape
        x = _lookup(params["embed"], tokens).to(self._dt)               # [B, Sp, d]
        if cfg.family == "ssm":
            return self._rwkv_prefill(params, x, cache)
        if source is not None and "cross_k" not in cache:
            raise ValueError("prefill: a source needs a cache made with source_len")
        if source_len is not None:
            source_len = torch.as_tensor(source_len, dtype=torch.int32, device=x.device)
        r = cache["k"].shape[2]
        if sp > r and not self._ring:
            raise ValueError(f"prefill: prompt of {sp} exceeds the cache "
                             f"length {r}")
        positions = torch.arange(sp, device=x.device)
        # the prompt's positions that stay in the cache, and their slots
        kept = slice(max(0, sp - r), sp)
        slots = kept if sp <= r else positions[kept] % r
        eps = cfg.norm_eps

        def cross(p, h, j, qk_norm=True):
            """Write cross layer j's source K/V, return its gated term."""
            ck, cv = self._source_kv(p, source.to(h.dtype))
            cache["cross_k"][j] = ck.to(cache["cross_k"].dtype)
            cache["cross_v"][j] = cv.to(cache["cross_v"].dtype)
            return self._cross_seq(p, h, ck, cv, source_len, qk_norm)

        for kind, i in self._schedule():
            if kind == "cross":                                        # vision's cross layer
                cp = _layer(params["cross_blocks"], i)
                if source is not None:
                    # the reference's lock-step prefill takes no q-norm here
                    x = x + cross(cp["cross"], rms_norm(x, cp["ln1"], eps), i, qk_norm=False)
                x = x + mlp_apply(cp["ffn"], rms_norm(x, cp["ln2"], eps), cfg.act,
                                  cfg.gated_mlp)
                continue
            bp = _layer(params["blocks"], i)
            p = bp["attn"]
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k, v = self._qkv_rope(p, h, positions)
            if "k_scale" in cache:
                kq, k_s = quantize_kv(k)                               # k_s [B, Sp, Hkv]
                vq, v_s = quantize_kv(v)
                cache["k"][i][:, slots] = kq[:, kept]
                cache["v"][i][:, slots] = vq[:, kept]
                sdt = cache["k_scale"].dtype
                cache["k_scale"][i][:, :, slots] = k_s[:, kept].transpose(1, 2).to(sdt)
                cache["v_scale"][i][:, :, slots] = v_s[:, kept].transpose(1, 2).to(sdt)
            else:
                _put_span(cache["k"][i], slots, k[:, kept])
                _put_span(cache["v"][i], slots, v[:, kept])
            a = attn_lib.prefill_attention(q, k, v, causal=True, window=cfg.window,
                                           kv_block=cfg.attn_block or 512)
            attn_out = linear(p, "wo", a.reshape(b, sp, -1))
            if cfg.family == "hybrid":
                m_out, mst = mamba_lib.mamba_forward(bp["mamba"], h, return_state=True)
                cache["mamba_conv"][i], cache["mamba_ssm"][i] = mst.conv, mst.ssm
                x = x + self._mix_branches(bp, attn_out, m_out)
            else:
                x = x + attn_out
            if "cross" in bp and source is not None:                   # whisper's decoder
                x = x + cross(bp["cross"], rms_norm(x, bp["ln_cross"], eps), i)
            h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            x = x + self._ffn(bp["ffn"], h2)
        if source is not None and "source_len" in cache:
            if source_len is None:
                cache["source_len"].fill_(source.shape[1])
            else:
                cache["source_len"].copy_(source_len)
        cache["len"].fill_(sp)
        if cfg.rotary_dim and cfg.rope_mode == "incremental":
            self._reset_rope(cache, sp)
        x = rms_norm(x[:, -1, :], params["ln_f"], cfg.norm_eps)
        return self._unembed(params, x), cache

    # ---- slot-targeted ragged prefill (continuous batching) ----------------
    def supports_ragged_serving(self) -> bool:
        """Chunked slot prefill and parked ragged decode cover every family
        (dense, MoE, RWKV6, hybrid; full or ring KV cache), the
        cross-attention stacks through the source-KV pool
        (``init_cache(n_sources=)``, :meth:`ingest_source`)."""
        return True

    def prefill_chunk(self, params: Params, tokens: torch.Tensor, cache: Cache,
                      slot: int, offset: int, last: int
                      ) -> tuple[torch.Tensor, Cache]:
        """Prefill one prompt chunk into cache slot ``slot``: tokens [C] run
        at positions [offset, offset + C), their K/V land in rows
        ``cache[k|v][:, slot, offset:offset + C]``, and the chunk attends
        causally to the slot's prefix through ``prefill_attention``'s
        ``kv_lengths`` / ``q_offset``. The caller pads the last chunk; its
        padded positions write dead rows past the committed length, which
        decode overwrites. ``cache['len']`` is untouched until
        :meth:`finalize_slot`. Only position ``last`` is unembedded.
        Returns (logits [V] f32, the cache updated in place).

        An int8 cache stores the chunk quantized, and the chunk attends the
        whole slot dequantized with its own positions overlaid by their
        fresh float K/V: quantization reaches a chunk's attention only
        through the prefix already stored, so a one-chunk prompt is
        bit-identical to the quantized lock-step prefill.

        A ring cache takes the chunk at slots ``pos % R`` (a prompt longer
        than the ring overwrites its own oldest, out-of-window entries);
        padded positions past ``last`` rewrite their slot's old value, so
        only real tokens occupy ring slots, and the chunk attends the ring
        through :func:`attn_lib.prefill_attention_ring` — exact while R >=
        window + C - 1 (the engine's bound).

        Recurrent families continue the slot's state: an RWKV6 stack (no KV
        rows; ``offset`` is implicit in its state) runs
        :meth:`_rwkv_prefill_chunk`, a hybrid layer's Mamba branch starts
        from the slot's (conv, ssm) state and writes it back, the positions
        past ``last`` exact no-ops.

        A cross layer reads the slot's pool entry (``src_index[slot]``,
        ingested at admission), non-causal and masked to the entry's
        ``src_len`` (an exact 0 where it is 0); an int8 pool dequantizes
        just that entry. The entry is selected on the device: no host
        read."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self._rwkv_prefill_chunk(params, tokens, cache, slot, last)
        (c,) = tokens.shape
        smax = cache["k"].shape[2]
        ring = self._ring
        if offset + c > smax and not ring:
            raise ValueError(f"prefill_chunk: rows [{offset}, {offset + c}) "
                             f"exceed the cache length {smax}")
        dev = tokens.device
        x = params["embed"][tokens].to(self._dt)[None]                 # [1, C, d]
        positions = offset + torch.arange(c, device=dev)
        kv_len = torch.full((1,), offset + c, dtype=torch.int32, device=dev)
        q_off = torch.full((1,), offset, dtype=torch.int32, device=dev)
        keep = None
        if ring:
            rows = positions % smax
            keep = torch.arange(c, device=dev) <= last
        else:
            rows = slice(offset, offset + c)
        eps = cfg.norm_eps
        pooled = "src_k" in cache
        if pooled:
            entry = cache["src_index"][slot:slot + 1].long()           # [1], on the device
            src_n = cache["src_len"].index_select(0, entry)

        def cross_read(p, h, j):
            """The chunk's gated cross term against the slot's entry in
            cross layer j's pool."""
            sk = cache["src_k"][j].index_select(0, entry)              # [1, S_src, Hkv, Dh]
            sv = cache["src_v"][j].index_select(0, entry)
            if "src_k_scale" in cache:
                sk = dequantize_cache(sk, cache["src_k_scale"][j].index_select(0, entry))
                sv = dequantize_cache(sv, cache["src_v_scale"][j].index_select(0, entry))
            return self._cross_seq(p, h, sk, sv, src_n)

        for kind, i in self._schedule():
            if kind == "cross":                                        # vision's cross layer
                cp = _layer(params["cross_blocks"], i)
                if pooled:
                    x = x + cross_read(cp["cross"], rms_norm(x, cp["ln1"], eps), i)
                x = x + mlp_apply(cp["ffn"], rms_norm(x, cp["ln2"], eps), cfg.act,
                                  cfg.gated_mlp)
                continue
            bp = _layer(params["blocks"], i)
            p = bp["attn"]
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k, v = self._qkv_rope(p, h, positions)
            k_slot = cache["k"][i, slot:slot + 1]                      # [1, S, Hkv, Dh]
            v_slot = cache["v"][i, slot:slot + 1]
            rows3 = (c, 1, 1)                                          # keep's view on rows
            if "k_scale" in cache:
                k_fp, v_fp = k, v
                kq, k_s = quantize_kv(k)                               # k_s [1, C, Hkv]
                vq, v_s = quantize_kv(v)
                _put(k_slot[0], rows, kq[0], keep, rows3)
                _put(v_slot[0], rows, vq[0], keep, rows3)
                ks_slot = cache["k_scale"][i, slot:slot + 1]           # [1, Hkv, S]
                vs_slot = cache["v_scale"][i, slot:slot + 1]
                _put(ks_slot[0], (slice(None), rows), k_s[0].T, keep, (1, c))
                _put(vs_slot[0], (slice(None), rows), v_s[0].T, keep, (1, c))
                k_att = k_slot.float() * ks_slot.transpose(1, 2)[..., None]
                v_att = v_slot.float() * vs_slot.transpose(1, 2)[..., None]
                _put(k_att[0], rows, k_fp[0].float(), keep, rows3)    # fresh-fp overlay
                _put(v_att[0], rows, v_fp[0].float(), keep, rows3)
            else:
                _put(k_slot[0], rows, k[0], keep, rows3)
                _put(v_slot[0], rows, v[0], keep, rows3)
                k_att, v_att = k_slot, v_slot
            if ring:
                a = attn_lib.prefill_attention_ring(q, k_att, v_att, positions,
                                                    offset + last, window=cfg.window)
            else:
                a = attn_lib.prefill_attention(q, k_att, v_att, causal=True,
                                               window=cfg.window, kv_lengths=kv_len,
                                               q_offset=q_off,
                                               kv_block=cfg.attn_block or 512)
            attn_out = linear(p, "wo", a.reshape(1, c, -1))
            if cfg.family == "hybrid":
                st0 = mamba_lib.MambaState(cache["mamba_conv"][i, slot:slot + 1],
                                           cache["mamba_ssm"][i, slot:slot + 1])
                m_out, mst = mamba_lib.mamba_forward(bp["mamba"], h, return_state=True,
                                                     state=st0, n_valid=last + 1)
                cache["mamba_conv"][i, slot], cache["mamba_ssm"][i, slot] = mst.conv[0], mst.ssm[0]
                x = x + self._mix_branches(bp, attn_out, m_out)
            else:
                x = x + attn_out
            if "cross" in bp and pooled:                               # whisper's decoder
                x = x + cross_read(bp["cross"], rms_norm(x, bp["ln_cross"], eps), i)
            h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            # capacity = the chunk: a token takes an expert at most once, so
            # nothing drops and a padded position cannot evict a real one
            x = x + self._ffn(bp["ffn"], h2, capacity=c)
        x_last = rms_norm(x[:, last], params["ln_f"], cfg.norm_eps)
        return self._unembed(params, x_last)[0], cache

    def prefill_chunks_batched(self, params: Params, tokens: torch.Tensor,
                               cache: Cache, slots, offsets, lasts, valid
                               ) -> tuple[torch.Tensor, Cache]:
        """Advance N mid-prefill slots one chunk each: :meth:`prefill_chunk`
        per row with ``valid`` true, in row order (slots write disjoint
        rows, so the order changes nothing); rows with ``valid`` false leave
        the cache untouched and give zero logits.

        tokens: [N, C] int; slots/offsets/lasts/valid: N host ints / bools.
        Returns (logits [N, V] f32, meaningful on a request's final chunk
        only, and the cache updated in place)."""
        logits = torch.zeros((tokens.shape[0], self.cfg.vocab_size),
                             dtype=torch.float32, device=tokens.device)
        for i, ok in enumerate(valid):
            if ok:
                logits[i], cache = self.prefill_chunk(
                    params, tokens[i], cache, int(slots[i]), int(offsets[i]),
                    int(lasts[i]))
        return logits, cache

    # ---- the source-KV pool (continuous cross-attention serving) ----------
    def ingest_source(self, params: Params, source: torch.Tensor, cache: Cache,
                      entry: int, length: int) -> Cache:
        """Write one source's K/V into pool entry ``entry``, once, at
        admission: ``source`` [S_max, d] padded to the pool's rows,
        ``length`` its valid prefix. Every cross layer projects it (no
        RoPE); rows past ``length`` are zeroed before an int8 pool
        quantizes them, so the entry holds (real K/V, zeros) and scale 0 on
        the tail, never a previous occupant's. The engine's
        ``SourceKVPool`` decides the entry."""
        cfg = self.cfg
        src = source.to(self._dt)
        stacked = params["cross_blocks"] if cfg.cross_attn_every > 1 else params["blocks"]
        keep = (torch.arange(src.shape[0], device=src.device) < length)[:, None, None]
        for j in range(self._n_cross_kv()):
            k, v = self._source_kv(_layer(stacked, j)["cross"], src)   # [S, Hkv, Dh]
            k = torch.where(keep, k, 0)
            v = torch.where(keep, v, 0)
            if "src_k_scale" in cache:
                k, k_s = quantize_kv(k)                                # k_s [S, Hkv]
                v, v_s = quantize_kv(v)
                cache["src_k_scale"][j, entry] = k_s.T.to(cache["src_k_scale"].dtype)
                cache["src_v_scale"][j, entry] = v_s.T.to(cache["src_v_scale"].dtype)
            cache["src_k"][j, entry] = k.to(cache["src_k"].dtype)
            cache["src_v"][j, entry] = v.to(cache["src_v"].dtype)
        cache["src_len"][entry] = length
        return cache

    def assign_source(self, cache: Cache, slot: int, entry: int) -> Cache:
        """Point slot ``slot``'s cross reads at pool entry ``entry``; any
        number of slots may share an entry."""
        cache["src_index"][slot] = entry
        return cache

    def release_source(self, cache: Cache, entry: int) -> Cache:
        """Zero pool entry ``entry`` (rows, scales, ``src_len``) once its
        last holder retired: a slot still pointing at it reads an exact 0,
        and a later request never sees the previous source."""
        for key in ("src_k", "src_v", "src_k_scale", "src_v_scale"):
            if key in cache:
                cache[key][:, entry] = 0
        cache["src_len"][entry] = 0
        return cache

    def finalize_slot(self, cache: Cache, slot: int, length: int) -> Cache:
        """Commit a slot's chunked prefill: set its length and reseed its
        incremental-RoPE state at position ``length``."""
        cfg = self.cfg
        cache["len"][slot] = length
        if cfg.rotary_dim and cfg.rope_mode == "incremental":
            rs = rope_lib.rope_state_init(cfg.resolved_head_dim, cfg.rope_base,
                                          length, cfg.rotary_dim,
                                          device=self.device)
            cache["rope_cos"][slot] = rs.cos_m
            cache["rope_sin"][slot] = rs.sin_m
        return cache

    def release_slot(self, cache: Cache, slot: int) -> Cache:
        """Reset-on-release: the slot's length drops to 0, so nothing in its
        rows is attended again. An int8 cache also zeroes the slot's rows
        and scales, so a released slot's (rows, scales) are all zero and a
        stale row can never dequantize to a previous occupant's value. A
        ring cache zeroes its rows too (the position rule already masks a
        previous occupant's slots until the next one wraps), as the
        reference does: a released slot is all zeros. Recurrent state
        (RWKV6's, Mamba's) is zeroed too: it feeds forward multiplicatively,
        so the next occupant's first chunk must start from the empty state."""
        cache["len"][slot] = 0
        for key in _RECURRENT_KEYS:
            if key in cache:
                cache[key][:, slot] = 0
        if self._ring or "k_scale" in cache:
            for key in ("k", "v", "k_scale", "v_scale"):
                if key in cache:
                    cache[key][:, slot] = 0
        return cache

    # ---- the RWKV6 stack (family "ssm"): no KV cache -------------------------
    def _rwkv_layers(self, params: Params, x: torch.Tensor, cache: Cache, rows,
                     n_valid: int | None = None) -> torch.Tensor:
        """The RWKV6 blocks over a sequence ``x`` [B, S, d], each seeded from
        the cache's state planes at ``rows`` and writing its state back
        there; positions >= ``n_valid`` are padding."""
        cfg = self.cfg
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            st = rwkv_lib.RWKVLayerState(cache["rwkv_att"][i, rows], cache["rwkv_ffn"][i, rows],
                                         cache["rwkv_wkv"][i, rows])
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            y, st = rwkv_lib.rwkv_time_mix(bp["mix"], h, st, cfg.rwkv_head_dim,
                                           n_valid=n_valid)
            x = x + y
            h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            y2, st = rwkv_lib.rwkv_channel_mix(bp["mix"], h2, st, n_valid=n_valid)
            x = x + y2
            cache["rwkv_att"][i, rows] = st.x_prev_att
            cache["rwkv_ffn"][i, rows] = st.x_prev_ffn
            cache["rwkv_wkv"][i, rows] = st.wkv
        return x

    def _rwkv_prefill(self, params: Params, x: torch.Tensor,
                      cache: Cache) -> tuple[torch.Tensor, Cache]:
        """Lock-step prefill of the RWKV6 stack from the empty state."""
        for key in ("rwkv_att", "rwkv_ffn", "rwkv_wkv"):
            cache[key].zero_()
        x = self._rwkv_layers(params, x, cache, slice(None))
        cache["len"].fill_(x.shape[1])
        x = rms_norm(x[:, -1, :], params["ln_f"], self.cfg.norm_eps)
        return self._unembed(params, x), cache

    def _rwkv_prefill_chunk(self, params: Params, tokens: torch.Tensor, cache: Cache,
                            slot: int, last: int) -> tuple[torch.Tensor, Cache]:
        """One prompt chunk of one slot through the RWKV6 stack: the slot's
        state seeds the chunk and the state after position ``last`` is
        written back, so successive chunks compose into the whole prompt's
        recurrence."""
        x = params["embed"][tokens].to(self._dt)[None]                # [1, C, d]
        x = self._rwkv_layers(params, x, cache, slice(slot, slot + 1), n_valid=last + 1)
        x_last = rms_norm(x[:, last], params["ln_f"], self.cfg.norm_eps)
        return self._unembed(params, x_last)[0], cache

    def _rwkv_decode_step(self, params: Params, x: torch.Tensor, cache: Cache,
                          active: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, Cache]:
        cfg = self.cfg
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            st = rwkv_lib.RWKVLayerState(cache["rwkv_att"][i], cache["rwkv_ffn"][i],
                                         cache["rwkv_wkv"][i])
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            y, st = rwkv_lib.rwkv_time_mix_step(bp["mix"], h, st, cfg.rwkv_head_dim,
                                                active=active)
            x = x + y
            h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            y2, st = rwkv_lib.rwkv_channel_mix_step(bp["mix"], h2, st, active=active)
            x = x + y2
            cache["rwkv_att"][i], cache["rwkv_ffn"][i] = st.x_prev_att, st.x_prev_ffn
            cache["rwkv_wkv"][i] = st.wkv
        cache["len"] += 1 if active is None else active.to(torch.int32)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._unembed(params, x), cache
