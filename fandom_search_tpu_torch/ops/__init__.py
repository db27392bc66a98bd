"""Device ops: each module holds one CUDA kernel wrapper and its plain PyTorch version."""
