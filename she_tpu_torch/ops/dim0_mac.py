"""The dim-0 MAC: a lazy sum over j of products of two operands, mod q.

she_tpu computes it as jnp code that XLA fuses, three times over: the
dim-0 inner products of PIR serving (she_tpu/pir/serving.py:318
dim0_inner_products, :344 _dim0_inner_products_w64), the BSGS products of
PNNS serving (she_tpu/pnns/serving.py:52 bsgs_inner_products, :75
_bsgs_inner_products_w64) and bfv.inner_product_ct_pt
(she_tpu/bfv/bfv.py:876). The port runs all three as one function,

    out[m1, m2, l, k] = sum_j a[m1, j, l, k] * b[j, m2, l, k]  mod q_l

for a [*M1, J, L, N] and b [J, *M2, L, N] -> [*M1, *M2, L, N], fully
reduced. It dispatches on its data's device: a CPU tensor takes the plain
PyTorch version below, the lazy multiply-add stream of
ops/modarith.sum_products_mod (int64 on the int64 route, (hi, lo) pairs
on the wide route), and a CUDA tensor the hand-written kernel of
ops/dim0_mac_cuda.py (csrc/dim0_mac.cu); anything else raises.
`plain_calls_on_cuda` counts plain calls on CUDA tensors, which only a
comparison against the kernel should make. The output is the unique
residue, so the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from . import dim0_mac_cuda
from . import modarith as ma

plain_calls_on_cuda = {"dim0_mac": 0}


def dim0_mac_plain(a: torch.Tensor, b: torch.Tensor, ctx) -> torch.Tensor:
    """a [*M1, J, L, N], b [J, *M2, L, N] over ctx's moduli ->
    [*M1, *M2, L, N]: the lazy stream over j, reduced every
    ctx.max_signed_lazy_product_count() products."""
    if a.device.type == "cuda":
        plain_calls_on_cuda["dim0_mac"] += 1
    m1 = a.dim() - 3
    spread = (slice(None),) * m1 + (None,) * (b.dim() - 3)  # a's rows against every m2
    terms = ((a.select(m1, j)[spread], b[j]) for j in range(b.shape[0]))
    return ma.sum_products_mod(terms, ctx.q_col, ctx.max_signed_lazy_product_count())


def dim0_mac(a: torch.Tensor, b: torch.Tensor, ctx) -> torch.Tensor:
    if a.device.type == "cuda":
        return dim0_mac_cuda.dim0_mac(a, b, ctx.moduli)
    if a.device.type == "cpu":
        return dim0_mac_plain(a, b, ctx)
    raise ValueError(f"no dim0_mac for device {a.device}")
