"""The benchmark of she_tpu_torch, the PyTorch and CUDA port (see README.md)."""
