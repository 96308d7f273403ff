"""Quickstart of the PyTorch/CUDA port: the SwiftKV attention algorithm in 60
seconds.

Shows the paper's core contribution end to end:
  1. the per-token single-pass recurrence (Eqs. 5-8) == two-pass softmax
  2. the blockwise form and the decode kernel (on the GPU the hand-written
     CUDA kernel, ``csrc/swiftkv_decode.cu``; on the CPU its plain version)
  3. the monoid merge that makes it sequence-parallel
  4. the LUT exponential (Eqs. 9-10) and the Q15.17 fixed-point datapath

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the GPU by default; with no GPU it raises unless ``--device cpu``).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import exp2_lut, fixedpoint, swiftkv
from repro_torch.core.swiftkv import (state_finalize, state_init, state_merge,
                                      state_update_block)
from repro_torch.device import resolve_device
from repro_torch.kernels.swiftkv_decode import ops as kernel_ops

TOL = 1e-5     # max |error| of each float32 form against the two-pass oracle


def run(device) -> dict:
    """The four parts on ``device``, from numpy's draws of seed 0 (the
    reference's inputs); prints the reference's lines and returns what
    they print."""
    rng = np.random.default_rng(0)
    d, n = 128, 512
    qn = rng.standard_normal(d).astype(np.float32)
    kn = rng.standard_normal((n, d)).astype(np.float32)
    vn = rng.standard_normal((n, d)).astype(np.float32)
    q, k, v = (torch.as_tensor(a, device=device) for a in (qn, kn, vn))
    # one row, one KV head, one query: q [B, Hkv, G, D], caches [B, S, Hkv, D]
    q4, k4, v4 = q[None, None, None], k[None, :, None], v[None, :, None]
    out_ref = swiftkv.softmax_attention_reference(q4, k4, v4)[0, 0, 0]
    err = lambda out: float((out - out_ref).abs().max())
    res = {}

    # 1. paper-faithful per-token single pass vs the two-pass oracle
    res["tokenwise"] = err(swiftkv.swiftkv_decode_tokenwise(q4, k4, v4)[0, 0, 0])
    print("tokenwise vs two-pass softmax:", res["tokenwise"])

    # 2. blockwise + the decode kernel
    res["blockwise"] = err(swiftkv.swiftkv_decode_blockwise(q4, k4, v4, block_size=128)[0, 0, 0])
    print("blockwise  vs two-pass softmax:", res["blockwise"])
    out_kern = kernel_ops.swiftkv_decode(
        q[None, None, :], k[None, :, None, :], v[None, :, None, :],
        torch.tensor([n], dtype=torch.int32, device=device))[0, 0]
    res["kernel"] = err(out_kern)
    print("decode kernel vs two-pass softmax:", res["kernel"])

    # 3. sequence-parallel: fold two halves independently, merge the
    #    (mu, Z, Y) triples — exact, O(d) communication per head
    scale = 1.0 / np.sqrt(d)
    halves = []
    for lo, hi in ((0, n // 2), (n // 2, n)):
        s = (k[lo:hi] @ q) * scale
        halves.append(state_update_block(state_init(d, device=device), s, v[lo:hi],
                                         torch.ones(hi - lo, device=device)))
    res["merged"] = err(state_finalize(state_merge(*halves)))
    print("split-fold + monoid merge vs oracle:", res["merged"])

    # 4. the hardware numerics (Eqs. 9-10 + Q15.17)
    res["lut_max_rel_err"] = exp2_lut.max_relative_error()
    print("LUT exp max rel err (paper: 5.86e-5):", f"{res['lut_max_rel_err']:.3e}")
    out_fxp = fixedpoint.swiftkv_attention_fxp(qn, kn, vn)
    res["fxp_mean_abs_err"] = float(np.mean(np.abs(out_fxp - out_ref.cpu().numpy())))
    print("Q15.17 fixed-point attention mean abs err:", f"{res['fxp_mean_abs_err']:.2e}")

    for name in ("tokenwise", "blockwise", "kernel", "merged"):
        assert res[name] <= TOL, (name, res[name])
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
