"""SwiftKV single-pass decode attention: CUDA kernel + plain version."""
