"""Rotary positional embedding: direct form + the paper's decoder-specialized
incremental recurrence (Eq. 11). Port of ``repro.core.rope``, with the same
operation order so that the incremental form drifts as the reference's does.

Pairing convention: half-split ("NeoX"/llama style) — channel i pairs with
channel i + d/2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def rope_freqs(head_dim: int, base: float = 10000.0,
               rotary_dim: int | None = None, *,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Angular frequencies omega_i (Eq. 1), float32 [rd/2]."""
    rd = head_dim if rotary_dim is None else rotary_dim
    i = torch.arange(rd // 2, dtype=torch.float32, device=device)
    # a device-side constant: no host-to-device copy on the decode path
    return torch.full((), base, dtype=torch.float32, device=device) ** (-2.0 * i / rd)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0,
               rotary_dim: int | None = None) -> torch.Tensor:
    """Direct RoPE. x: [..., S, D]; positions: [S] or broadcastable [..., S]."""
    d = x.shape[-1]
    rd = d if rotary_dim is None else rotary_dim
    freqs = rope_freqs(d, base, rotary_dim, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs          # [..., S, rd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., : rd // 2], x_rot[..., rd // 2:]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.cat([r1, r2, x_pass], dim=-1).to(x.dtype)


class RopeState(NamedTuple):
    """Cached (cos m*theta, sin m*theta) for the current position m, plus the
    per-step rotation constants (a, b) = (cos theta, sin theta)."""
    cos_m: torch.Tensor  # [rd/2] f32
    sin_m: torch.Tensor  # [rd/2] f32
    a: torch.Tensor      # [rd/2] f32, cos(theta_i)
    b: torch.Tensor      # [rd/2] f32, sin(theta_i)


def rope_state_init(head_dim: int, base: float = 10000.0, position: int = 0,
                    rotary_dim: int | None = None, *,
                    device: torch.device | str = "cpu") -> RopeState:
    freqs = rope_freqs(head_dim, base, rotary_dim, device=device)
    m = torch.full((), position, dtype=torch.float32, device=device)
    return RopeState(cos_m=torch.cos(m * freqs), sin_m=torch.sin(m * freqs),
                     a=torch.cos(freqs), b=torch.sin(freqs))


def rope_state_advance(state: RopeState) -> RopeState:
    """Angle addition: cos((m+1)t) = cos(mt)cos(t) - sin(mt)sin(t), etc.
    Four multiplies per channel pair — Eq. 11's datapath."""
    cos_next = state.cos_m * state.a - state.sin_m * state.b
    sin_next = state.sin_m * state.a + state.cos_m * state.b
    return RopeState(cos_m=cos_next, sin_m=sin_next, a=state.a, b=state.b)


def apply_rope_from_state(x: torch.Tensor, state: RopeState) -> torch.Tensor:
    """Rotate a single-position vector with the cached angle state.
    x: [..., D] (one token)."""
    rd = 2 * state.cos_m.shape[-1]
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., : rd // 2], x_rot[..., rd // 2:]
    r1 = x1 * state.cos_m - x2 * state.sin_m
    r2 = x1 * state.sin_m + x2 * state.cos_m
    return torch.cat([r1, r2, x_pass], dim=-1).to(x.dtype)
