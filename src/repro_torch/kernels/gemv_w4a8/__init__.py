"""W4A8 GEMV/GEMM: CUDA kernel + plain version."""
