"""PyTorch/CUDA port of the SwiftKV reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
layout and names so each piece can be held against its counterpart. It
imports ``torch``, ``numpy`` and the standard library only: nothing of JAX
and nothing of ``repro``.

Ported so far: the dense lock-step serving path (``llama2-7b``,
``qwen3-8b`` and their ``+w4a8`` forms) with the two hand-written Hopper
kernels, ``kernels/swiftkv_decode`` and ``kernels/gemv_w4a8``.
"""
