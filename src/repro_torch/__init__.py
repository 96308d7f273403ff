"""PyTorch/CUDA port of the SwiftKV reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
layout and names so each piece can be held against its counterpart. It
imports ``torch``, ``numpy`` and the standard library only: nothing of JAX
and nothing of ``repro``.

It serves all 12 of the reference's configs, lock-step and continuous,
through the two hand-written Hopper kernels (``kernels/swiftkv_decode``,
``kernels/gemv_w4a8``), and trains them (``train``, ``optim``, ``data``,
``checkpoint``, ``launch/train.py``). The device mesh, FSDP and the
dry-run are not ported yet.
"""
