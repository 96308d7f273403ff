"""Decoder-only transformer, dense family. Port of the serving side of
``repro.models.transformer`` (``init_params``, ``init_cache``, ``prefill``,
``decode_step`` with ``active=None``, ``_unembed``).

Decode (the paper's workload) keeps a KV cache ``[L, B, Smax, Hkv, Dh]``;
keys are cached post-RoPE (paper §IV-C) and the new token's q/k rotation
uses the incremental Eq. 11 recurrence carried in the cache
(``rope_mode="incremental"``) or direct cos/sin (``"direct"``).

Unlike the reference, whose arrays are immutable, ``prefill`` and
``decode_step`` update the cache dict's tensors in place and return the
same dict: a full-width cache is gigabytes, and a copy per step would
double the decode step's memory traffic.

``cfg.decode_impl`` chooses the decode attention: ``kernel`` goes through
the hand-written kernel's wrapper (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors); ``blockwise`` and ``naive`` run plain
PyTorch on any device. W4A8 projections choose by device alone
(``layers.linear``): on the GPU they always launch the GEMV kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import attention as attn_lib
from repro_torch.core import rope as rope_lib
from repro_torch.core.quantization import quantize_kv
from repro_torch.device import resolve_device
from .config import ModelConfig
from .layers import dense_init, embed_init, linear, mlp_apply, mlp_init, rms_norm

Params = dict
Cache = dict


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` params tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class TransformerLM:
    """Dense decoder LM. Other families raise ``NotImplementedError``."""

    def __init__(self, cfg: ModelConfig, *,
                 device: str | torch.device | None = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                "(ROADMAP §1 items 8-10)")
        if cfg.kv_ring:
            raise NotImplementedError(
                f"{cfg.name}: ring KV caches are not ported yet (ROADMAP §1 item 7)")
        if cfg.decode_impl not in ("kernel", "blockwise", "naive"):
            raise NotImplementedError(
                f"decode_impl={cfg.decode_impl!r} is not ported "
                "(kernel | blockwise | naive); see ROADMAP §1")
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def _dt(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # ---- init ------------------------------------------------------------
    def init_params(self, seed: int = 0, *,
                    dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on the
        model's device, in the reference's tree layout. ``dtype`` stores the
        embedding and projection matrices (float32 masters, like the
        reference, by default; the compute dtype halves a full-width
        model's memory); norm weights stay float32."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        d, dh = cfg.d_model, cfg.resolved_head_dim
        hq, hkv, n_layers = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
        ones = lambda *s: torch.ones(s, dtype=torch.float32, device=self.device)
        params: Params = {"ln_f": ones(d),
                          "embed": embed_init(gen, cfg.vocab_size, d, dtype=dtype)}
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, (d, cfg.vocab_size), dtype=dtype)
        attn = {"wq": dense_init(gen, (n_layers, d, hq * dh), dtype=dtype),
                "wk": dense_init(gen, (n_layers, d, hkv * dh), dtype=dtype),
                "wv": dense_init(gen, (n_layers, d, hkv * dh), dtype=dtype),
                "wo": dense_init(gen, (n_layers, hq * dh, d), dtype=dtype)}
        if cfg.qk_norm:
            attn["qn"] = ones(n_layers, dh)
            attn["kn"] = ones(n_layers, dh)
        params["blocks"] = {
            "ln1": ones(n_layers, d), "attn": attn, "ln2": ones(n_layers, d),
            "ffn": mlp_init(gen, (n_layers,), d, cfg.d_ff, cfg.gated_mlp,
                            dtype=dtype)}
        return params

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return (x @ w.to(x.dtype)).float()

    # ---- KV cache ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *,
                   kv_dtype: torch.dtype | None = None) -> Cache:
        """Preallocated decode state: KV tensors [L, B, Smax, Hkv, Dh] in
        the KV storage dtype (int8 for ``+w4a8`` configs, else the compute
        dtype), per-row lengths, and the incremental-RoPE angle state.

        An int8 cache adds bf16 dequant scales ``k_scale``/``v_scale``
        [L, B, Hkv, Smax] (position last). For ``decode_impl="kernel"``
        ``max_len`` rounds up to a multiple of 128 (of 8 for caches of at
        most 128), as the reference does for its TPU kernel, so cache
        shapes compare one to one; the CUDA kernel itself needs no
        alignment."""
        cfg = self.cfg
        dh = cfg.resolved_head_dim
        dev = self.device
        kv_len = max_len
        if cfg.decode_impl == "kernel":
            mult = 128 if kv_len > 128 else 8
            kv_len = -(-kv_len // mult) * mult
        kv_dt = kv_dtype or (torch.int8 if cfg.w4a8_serve else self._dt)
        cache: Cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        shape = (cfg.n_layers, batch, kv_len, cfg.n_kv_heads, dh)
        cache["k"] = torch.zeros(shape, dtype=kv_dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=kv_dt, device=dev)
        if kv_dt == torch.int8:
            sshape = (cfg.n_layers, batch, cfg.n_kv_heads, kv_len)
            cache["k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=dev)
            cache["v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=dev)
        if cfg.rotary_dim:
            self._reset_rope(cache, 0)
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
                          cache: Cache) -> torch.Tensor:
        cfg = self.cfg
        b = h.shape[0]
        dh = cfg.resolved_head_dim
        q = linear(p, "wq", h).reshape(b, cfg.n_heads, dh)
        k = linear(p, "wk", h).reshape(b, cfg.n_kv_heads, dh)
        v = linear(p, "wv", h).reshape(b, cfg.n_kv_heads, dh)
        if cfg.qk_norm:
            q = rms_norm(q, p["qn"], cfg.norm_eps)
            k = rms_norm(k, p["kn"], cfg.norm_eps)
        q, k = self._rope_qk_decode(cache, q, k)
        kc, vc = cache["k"][layer], cache["v"][layer]                 # [B, S, Hkv, Dh]
        rows = torch.arange(b, device=h.device)
        pos = cache["len"].long() % kc.shape[1]
        ksc = vsc = None
        if "k_scale" in cache:
            # int8 cache: quantize the new token's K/V over Dh per head
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            ksc, vsc = cache["k_scale"][layer], cache["v_scale"][layer]  # [B, Hkv, S]
            ksc[rows, :, pos] = k_s.to(ksc.dtype)
            vsc[rows, :, pos] = v_s.to(vsc.dtype)
        kc[rows, pos] = k.to(kc.dtype)
        vc[rows, pos] = v.to(vc.dtype)
        out = attn_lib.decode_attention(q, kc, vc, cache["len"] + 1,
                                        impl=cfg.decode_impl, window=cfg.window,
                                        block_size=cfg.attn_block or 512,
                                        k_scale=ksc, v_scale=vsc)
        return linear(p, "wo", out.reshape(b, -1))

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Cache) -> tuple[torch.Tensor, Cache]:
        """tokens: [B] int -> (logits [B, V] f32, the cache updated in place)."""
        cfg = self.cfg
        x = params["embed"][tokens].to(self._dt)                       # [B, d]
        blocks = params["blocks"]
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            x = x + self._decode_self_attn(bp["attn"], h, i, cache)
            h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            x = x + mlp_apply(bp["ffn"], h2, cfg.act, cfg.gated_mlp)
        cache["len"] += 1
        self._advance_rope(cache)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._unembed(params, x), cache

    # ---- prefill ------------------------------------------------------------
    def prefill(self, params: Params, tokens: torch.Tensor,
                cache: Cache) -> tuple[torch.Tensor, Cache]:
        """tokens: [B, Sp] (uniform prompt length) -> (last-position logits
        [B, V] f32, the cache filled in place). Keys are cached post-RoPE.
        An int8 cache stores quantized K/V, but attention here consumes the
        fresh float K/V, as in the reference."""
        cfg = self.cfg
        b, sp = tokens.shape
        dh = cfg.resolved_head_dim
        if sp > cache["k"].shape[2]:
            raise ValueError(f"prefill: prompt of {sp} exceeds the cache "
                             f"length {cache['k'].shape[2]}")
        x = params["embed"][tokens].to(self._dt)                       # [B, Sp, d]
        positions = torch.arange(sp, device=x.device)

        def rope(t):                                                   # [B, Sp, H, Dh]
            if not cfg.rotary_dim:
                return t
            return rope_lib.apply_rope(t.transpose(1, 2), positions, cfg.rope_base,
                                       cfg.rotary_dim).transpose(1, 2)

        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            p = bp["attn"]
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q = linear(p, "wq", h).reshape(b, sp, cfg.n_heads, dh)
            k = linear(p, "wk", h).reshape(b, sp, cfg.n_kv_heads, dh)
            v = linear(p, "wv", h).reshape(b, sp, cfg.n_kv_heads, dh)
            if cfg.qk_norm:
                q = rms_norm(q, p["qn"], cfg.norm_eps)
                k = rms_norm(k, p["kn"], cfg.norm_eps)
            q, k = rope(q), rope(k)
            if "k_scale" in cache:
                kq, k_s = quantize_kv(k)                               # k_s [B, Sp, Hkv]
                vq, v_s = quantize_kv(v)
                cache["k"][i, :, :sp] = kq
                cache["v"][i, :, :sp] = vq
                cache["k_scale"][i, :, :, :sp] = k_s.transpose(1, 2)
                cache["v_scale"][i, :, :, :sp] = v_s.transpose(1, 2)
            else:
                cache["k"][i, :, :sp] = k
                cache["v"][i, :, :sp] = v
            a = attn_lib.prefill_attention(q, k, v, causal=True, window=cfg.window,
                                           kv_block=cfg.attn_block or 512)
            x = x + linear(p, "wo", a.reshape(b, sp, -1))
            h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            x = x + mlp_apply(bp["ffn"], h2, cfg.act, cfg.gated_mlp)
        cache["len"].fill_(sp)
        if cfg.rotary_dim and cfg.rope_mode == "incremental":
            self._reset_rope(cache, sp)
        x = rms_norm(x[:, -1, :], params["ln_f"], cfg.norm_eps)
        return self._unembed(params, x), cache
