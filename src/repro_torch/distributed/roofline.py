"""Roofline terms of one (arch, shape, mesh) cell, and the model-FLOP
count they are held against. Port of the pure half of
``repro.distributed.roofline``:

    compute term    = per-rank FLOPs            / PEAK_FLOPS
    memory term     = per-rank bytes accessed   / HBM_BW
    collective term = per-rank collective bytes / LINK_BW

:func:`count_params` and :func:`model_flops_for_cell` are the reference's,
line for line (analytic, from a ``ModelConfig``: no model is built), and
:class:`RooflineReport` holds the terms and the fractions read from them.

The constants are one NVIDIA H100 SXM 80GB's at its 700 W limit: dense
bf16 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 at 450 GB/s each way per GPU
(the 8 GPUs of one node, all to all through NVSwitch). A mesh that spans
nodes crosses a slower network (InfiniBand, ~50 GB/s per GPU), so its
collective term here is a lower bound.

The reference's other half reads XLA's compiled artifacts:
``parse_collectives`` and ``shape_bytes`` the optimized HLO text,
``analyze`` its ``cost_analysis()``. The port has no HLO: its dry run
(``launch/dryrun.py``) runs a cell's step on the ``fake`` backend and
records each collective as it is issued, so :class:`CollectiveStats`
takes them one at a time (:meth:`CollectiveStats.add`, the body of
``parse_collectives``'s loop: the same ring-model factors), and
:func:`analyze` takes the counted terms and the stats in place of the
cost analysis and the HLO text.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM 80GB constants, per GPU
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12     # dense bf16 FLOP/s
HBM_BW = 3.35e12        # bytes/s
LINK_BW = 450e9         # NVLink 4 bytes/s each way


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclass
class CollectiveStats:
    """Per-kind operand bytes and per-rank link traffic (ring model), as the
    reference's. Each collective is one rank's program's, so its sizes are
    per rank already. Ring-algorithm traffic per rank:

        all-reduce    : 2 x (n-1)/n x operand bytes (RS + AG phases)
        all-gather    : (n-1)/n x output bytes
        reduce-scatter: (n-1)/n x operand bytes
        all-to-all    : (n-1)/n x operand bytes
        collective-permute : operand bytes (single hop)
    """
    op_bytes: dict[str, int] = field(default_factory=dict)
    op_counts: dict[str, int] = field(default_factory=dict)
    ici_bytes: float = 0.0

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.op_bytes.values())

    def add(self, kind: str, operand_bytes: int, result_bytes: int, group_size: int) -> None:
        """One collective of ``kind`` over a group of ``group_size`` ranks."""
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        f = (group_size - 1) / max(group_size, 1)
        if kind == "all-reduce":
            self.ici_bytes += 2 * f * operand_bytes
        elif kind == "all-gather":
            self.ici_bytes += f * result_bytes
        elif kind == "collective-permute":
            self.ici_bytes += operand_bytes
        else:  # reduce-scatter, all-to-all
            self.ici_bytes += f * operand_bytes
        self.op_bytes[kind] = self.op_bytes.get(kind, 0) + operand_bytes
        self.op_counts[kind] = self.op_counts.get(kind, 0) + 1


@dataclass
class RooflineReport:
    """``hlo_flops`` / ``hlo_bytes`` are per rank (the partitioned
    program's), so global figures are ranks x per-rank; each term is then
    global work over (ranks x the rank's peak) = per-rank work over the
    peak."""
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float              # per-rank FLOPs
    hlo_bytes: float              # per-rank bytes accessed
    collective_op_bytes: int      # summed operand sizes (per-rank program)
    collective_ici_bytes: float   # per-rank link traffic (ring model)
    bytes_per_chip: float         # peak live memory per device
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops: float = 0.0      # 6·N·D useful flops (global)
    op_counts: dict = field(default_factory=dict)

    def finalize(self):
        self.t_compute = self.hlo_flops / PEAK_FLOPS
        self.t_memory = self.hlo_bytes / HBM_BW
        # collective term: per-rank link traffic over the per-GPU link rate
        self.t_collective = self.collective_ici_bytes / LINK_BW
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        global_flops = self.hlo_flops * self.n_chips
        return self.model_flops / global_flops if global_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The share of the dominant resource's roofline that the *useful*
        work reaches: (model FLOPs at peak) / (bound time). For a memory- or
        collective-bound cell it reads as how much of the step is the
        unavoidable compute."""
        if self.t_bound <= 0:
            return 0.0
        t_useful = self.model_flops / (self.n_chips * PEAK_FLOPS)
        return t_useful / self.t_bound

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.n_chips,
            "chip_gflops": self.hlo_flops / 1e9,
            "chip_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.collective_op_bytes / 1e9,
            "ici_gbytes": self.collective_ici_bytes / 1e9,
            "bytes_per_chip_gb": self.bytes_per_chip / 1e9,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "dominant": self.dominant,
            "model_gflops": self.model_flops / 1e9,
            "useful_frac": self.useful_flops_fraction,
            "roofline_frac": self.roofline_fraction,
            "op_counts": self.op_counts,
        }


def analyze(arch: str, shape: str, mesh_name: str, n_chips: int, cost_analysis: dict,
            stats: CollectiveStats, bytes_per_chip: float,
            model_flops: float) -> RooflineReport:
    """The report of one cell: ``cost_analysis`` holds the per-rank
    ``flops`` and ``bytes accessed`` the dry run counted, ``stats`` its
    collectives (the reference parses them from the HLO text)."""
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=float(cost_analysis.get("flops", 0.0)),
        hlo_bytes=float(cost_analysis.get("bytes accessed", 0.0)),
        collective_op_bytes=stats.total_operand_bytes,
        collective_ici_bytes=stats.ici_bytes,
        bytes_per_chip=bytes_per_chip,
        model_flops=model_flops,
        op_counts=dict(stats.op_counts),
    )
    return rep.finalize()


# ---------------------------------------------------------------------------
# Model-FLOPs accounting (6·N·D rule, MoE-active-aware)
# ---------------------------------------------------------------------------

def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts from a ModelConfig — analytic, no
    instantiation. Active differs from total only for MoE (top_k experts)."""
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    dh = cfg.resolved_head_dim
    attn = d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * dh * d

    def ffn(n_used):
        per = d * dff * (3 if cfg.gated_mlp else 2)
        return per * max(n_used, 1) + (d * cfg.n_experts if cfg.n_experts else 0)

    if cfg.family == "ssm":
        d_att = 5 * d * d + d * max(32, d // 16) * 2     # rwkv time-mix
        d_ffn = 2 * d * dff + d * d
        layer_total = layer_active = d_att + d_ffn
        attn = 0
    else:
        layer_total = attn + ffn(cfg.n_experts or 1)
        layer_active = attn + ffn(cfg.top_k if cfg.n_experts else 1)
        if cfg.family == "hybrid":
            d_inner = cfg.ssm_expand * d
            mamba = (d * 2 * d_inner + d_inner * (1 + 2 * cfg.ssm_state)
                     + d_inner * d + cfg.ssm_conv * d_inner)
            layer_total += mamba
            layer_active += mamba

    n_layers = cfg.n_layers + getattr(cfg, "encoder_layers", 0)
    total = n_layers * layer_total + v * d * (1 if cfg.tie_embeddings else 2)
    active = n_layers * layer_active + v * d * (1 if cfg.tie_embeddings else 2)
    return int(total), int(active)


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for training; 2·N_active·D for inference
    (forward only). D = tokens processed by the step."""
    _, active = count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per row; attention reads the KV cache (not in 2ND —
    # add the 2·cache-dot FLOPs explicitly)
    tokens = shape.global_batch
    base = 2.0 * active * tokens
    if cfg.family != "ssm":
        dh = cfg.resolved_head_dim
        kv_len = min(shape.seq_len, cfg.window) if cfg.window else shape.seq_len
        attn_flops = (4.0 * cfg.n_heads * dh * kv_len) * cfg.n_layers * tokens
        base += attn_flops
    return base
