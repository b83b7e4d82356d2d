"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet): HBM3 at
3.35 TB/s, at the 700 W power limit. The integer pipes have no published
peak, so the kernels' share is a byte-bound share.
"""

HBM_BYTES_PER_S = 3.35e12
