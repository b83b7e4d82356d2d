"""she_tpu_torch: the PyTorch/CUDA port of she_tpu.

BFV homomorphic encryption and batched MulPIR serving on int64 torch
tensors, with hand-written CUDA kernels for the NVIDIA H100 (csrc/). The
package imports torch and never jax, and nothing of she_tpu: it keeps its
own copies of the host-only modules it needs. Entry points run on the CUDA
card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
