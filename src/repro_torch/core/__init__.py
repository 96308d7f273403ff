"""Core numerics of the port: SwiftKV attention, RoPE, W4A8 quantization."""
