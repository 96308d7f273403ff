"""Cycle-accurate cost model of the SwiftKV edge accelerator (paper §III-V).
The port's own copy of ``benchmarks/edge_cost_model.py`` (pure Python, the
same constants and names), so the installed package needs nothing from
``benchmarks``.

The paper's Figs. 7-8 and Tables III-IV are FPGA measurements; this container
has no FPGA, so we reproduce them with an explicit cycle model of the SKV
core's resources and of each attention schedule mapped onto the *same*
resources (exactly the paper's experimental setup: "identical set of exp
units and the same pipelined multiply and divide units").

Hardware parameters (from the paper):
  * Public MAC Array: 128 DSPs -> one 32-lane FXP32 dot-product step/cycle,
    i.e. a 128-d q.k_t dot takes DOT = 4 cycles (§IV-B).
  * LUT exponential: EXP_LAT cycles (5-bit LUT + interpolation, Eq. 10 ~3
    pipeline stages).
  * Divider: DIV_LAT cycles (pipelined divide unit).
  * Clock: 225 MHz; HBM: 460 GB/s.

Schedules (decode, per head, context N, head_dim 128):
  * SwiftKV  — per-token pipeline: while q.k_t streams through the MAC array
    (DOT cycles/token), the previous token's compare/exp/update retires in
    the shadow of the dot (§III: "all remaining updates can be scheduled
    within its latency"). One deferred divide at the end.
        cycles = FILL + N * DOT + DIV_LAT + d/LANES
  * Native   — two passes with score materialization and a softmax stage in
    between; no cross-stage pipelining (the conventional GEMM-based mapping,
    Fig. 1): score pass (load+dot per token, serialized), softmax pass
    (max scan, exp per score through the shared exp unit, sum, divide per
    score), PV pass (load + MAC per token, serialized).
  * Flash(B) — blockwise single-unit mapping: a block of B dots pipelines
    (DOT*B), but the blockwise-softmax epilogue (block max, B exps through
    the shared exp units, running rescale of Z and the [d] accumulator, with
    loop-carried dependencies) cannot overlap the next block's dots on one
    hardware set -> per-block stall (the paper's "forcing the computation to
    wait for block").
  * Streaming — two-pass online softmax (ITA-style [15]): pass 1 dots
    pipelined with running max/sum, pass 2 recomputes exp and accumulates PV
    (exp on the critical path of pass 2).

Free parameters EXP_LAT and DIV_LAT are calibrated once against Fig. 7(b)'s
three reported ratios (native 1x, Flash32 1.46x, Streaming 2.15x, SwiftKV
7.16x at N=512) — see ``calibrate()``; everything else is derived from the
paper's stated microarchitecture.
"""
from __future__ import annotations

from dataclasses import dataclass

D_HEAD = 128
LANES = 32          # FXP32 dot lanes/cycle (128 DSPs / 4 per FXP32 mult)
DOT = D_HEAD // LANES   # cycles per 128-d dot = 4
CLOCK_HZ = 225e6
HBM_BPS = 460e9
HBM_EFF = 0.62      # effective HBM utilization (calibrated to Table III's
                    # 12.3 ms/token for LLaMA2-7B; typical for FPGA HBM AXI)
KV_BYTES_PER_ELT = 1    # KV cache stored INT8 (SFU quantize/cast, Fig. 5c)

# EXP_LAT / DIV_LAT calibrated once against Fig. 7b's three reported ratios
# (grid search; see calibrate()) — physically plausible FPGA latencies for a
# LUT-exp pipeline and a 32-bit fixed-point divider. SCORE_RW models the
# score-buffer write+readback of schedules that materialize scores.
EXP_LAT = 7
DIV_LAT = 38
SCORE_RW = 2
FILL = 8            # pipeline fill/drain


def swiftkv_cycles(n: int, d: int = D_HEAD) -> float:
    """Per-token pipelined single pass: dot dominates; compare/exp/update
    retire in its shadow (§III). One deferred normalization (Eq. 8)."""
    return FILL + n * DOT + DIV_LAT + d // LANES


def native_cycles(n: int, d: int = D_HEAD) -> float:
    """Conventional two-pass with score materialization, serialized stages:
    score pass (dot + score-buffer write, not overlapped), softmax stage
    (max scan, exp per score through the shared exp unit, sum, divide per
    score on the pipelined divider), PV pass (score readback + MAC)."""
    score = n * (2 * DOT + SCORE_RW)
    softmax = n + n * EXP_LAT + n + (n + DIV_LAT)
    pv = n * (2 * DOT + SCORE_RW)
    return score + softmax + pv


def flash_cycles(n: int, block: int, d: int = D_HEAD) -> float:
    """Blockwise on one hardware set: B pipelined dots per block, then a
    non-overlapped epilogue (the paper's "waiting for block"): block max
    scan, B exps through the shared exp unit, block score-buffer traffic,
    rescale of the running (Z, Y[d]) accumulator, and the per-block output
    rescale through the divider ([d] elements + divider latency)."""
    n_blocks = -(-n // block)
    per_block = (block * DOT + block + block * EXP_LAT + SCORE_RW * block
                 + 2 * (d // LANES) + d + DIV_LAT)
    return FILL + n_blocks * per_block + DIV_LAT + d // LANES


def streaming_cycles(n: int, d: int = D_HEAD) -> float:
    """Two-pass online softmax [15]: pass 1 = dots + running max/sum with
    the exp unit on the critical path (EXP_LAT > DOT); pass 2 = recompute
    exp + MAC into the output; one final divide."""
    pass1 = n * max(DOT, EXP_LAT)
    pass2 = n * max(DOT, EXP_LAT)
    return FILL + pass1 + pass2 + DIV_LAT + d // LANES


def speedups_at(n: int = 512) -> dict[str, float]:
    base = native_cycles(n)
    return {
        "native": 1.0,
        "flash8": base / flash_cycles(n, 8),
        "flash16": base / flash_cycles(n, 16),
        "flash32": base / flash_cycles(n, 32),
        "streaming": base / streaming_cycles(n),
        "swiftkv": base / swiftkv_cycles(n),
    }


def calibrate() -> dict:
    """Report model ratios vs the paper's Fig. 7b targets."""
    got = speedups_at(512)
    targets = {"flash32": 1.46, "streaming": 2.15, "swiftkv": 7.16}
    return {k: {"model": round(got[k], 2), "paper": v,
                "rel_err": round(abs(got[k] - v) / v, 3)}
            for k, v in targets.items()}


# ---------------------------------------------------------------------------
# Model-level decode latency (Fig. 8a, Table III)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EdgeModel:
    name: str
    n_params: float          # weight count (decoder stack, excl. embeddings)
    d_model: int
    n_layers: int
    n_heads: int
    ctx: int
    vocab: int = 32000
    n_kv_heads: int | None = None   # MQA/GQA (ChatGLM2: 2)

    @property
    def weight_bytes(self) -> float:
        return self.n_params * 0.5   # W4: two params per byte

    @property
    def kv_frac(self) -> float:
        kv = self.n_kv_heads or self.n_heads
        return kv / self.n_heads


LLAMA2_7B = EdgeModel("llama2-7b", n_params=6.48e9, d_model=4096,
                      n_layers=32, n_heads=32, ctx=512)
CHATGLM_6B = EdgeModel("chatglm-6b", n_params=5.7e9, d_model=4096,
                       n_layers=28, n_heads=32, ctx=512, vocab=65024,
                       n_kv_heads=2)


def decode_latency_breakdown(m: EdgeModel, *, attention: str = "swiftkv",
                             flash_block: int = 32) -> dict:
    """Per-token decode latency split into module times (seconds).

    GEMV: the 32-processor array does a 4096-d dot/cycle (one output
    element/cycle, §IV-B) but weight *fetch* is the real bound: W4 weights
    stream from HBM once per token -> t = bytes/HBM. We take
    max(compute, HBM) per the dual bound. Attention: per-head cycles from
    the schedule model; 32 heads run on 32 processors in parallel, KV reads
    (2 * ctx * d_model * 2B fp16-equivalent... stored FXP/INT8 per §IV) also
    bound by HBM. SFU (norms/SiLU/rope): elementwise, d_model-wide vector
    ops, a few passes per layer."""
    # GEMV: compute cycles = one output element per cycle over all matmul
    # output dims per layer (q,k,v,o: 4*d^2; ffn: 3*d*2.7d) + lm head
    ffn_mult = 2.7          # llama-style gate/up/down
    out_elems = m.n_layers * (4 * m.d_model ** 2
                              + 3 * ffn_mult * m.d_model ** 2) / m.d_model
    gemv_compute = out_elems / CLOCK_HZ
    gemv_hbm = m.weight_bytes / (HBM_BPS * HBM_EFF)
    gemv = max(gemv_compute, gemv_hbm)

    # attention: 32 heads in parallel on 32 SKV processors
    sched = {"swiftkv": swiftkv_cycles,
             "native": native_cycles,
             "streaming": streaming_cycles,
             "flash": lambda n: flash_cycles(n, flash_block)}[attention]
    attn_cycles = sched(m.ctx) * m.n_layers          # heads parallel
    kv_bytes = (2 * m.ctx * m.d_model * m.n_layers * KV_BYTES_PER_ELT
                * m.kv_frac)
    attn = max(attn_cycles / CLOCK_HZ, kv_bytes / (HBM_BPS * HBM_EFF))

    # SFU: ~6 elementwise d_model-wide passes per layer at 32 lanes
    sfu = m.n_layers * 6 * (m.d_model / LANES) / CLOCK_HZ
    # lm head GEMV
    head = max(m.vocab * m.d_model * 0.5 / (HBM_BPS * HBM_EFF),
               m.vocab / CLOCK_HZ)
    total = gemv + attn + sfu + head
    return {"gemv_s": gemv, "attention_s": attn, "sfu_s": sfu,
            "lm_head_s": head, "total_s": total,
            "attention_share": attn / total,
            "tokens_per_s": 1.0 / total,
            "ms_per_token": total * 1e3}
