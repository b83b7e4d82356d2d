"""The BEHZ ciphertext product's three passes around its NTTs.

she_tpu multiplies two ciphertexts (eprint 2016/510) as jnp code that XLA
fuses: the lift of each ciphertext from q to [q, B_sk]
(she_tpu/core/rns.py:312-380, over RnsBaseConverter :56-136), a forward
NTT, the tensor product in the extended base (bfv/bfv.py:723-749, summed
over K pairs by inner_product_ct_ct :774-793), the scale by t and an
inverse NTT (drop_extended_base :762), then the floor back to q
(core/rns.py:382-461). The port runs a product as

    behz_lift (each side) -> forward NTT -> behz_tensor_mac -> inverse NTT -> behz_floor

Each function dispatches on its data's device: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor the hand-written kernel of
ops/behz_cuda.py (csrc/behz.cu), and anything else raises.
The tracer's registry counts plain calls on CUDA tensors
(plain_on_cuda.<op>), which only a comparison against the kernels should
make. Every output is fully reduced, so the kernels equal the plain
versions bit for bit.

* behz_lift: x [..., L, N] over q -> [..., L + L_bsk, N] over
  [q, B_sk] (the q rows copied): x m~ mod q_i, the approximate
  conversion to [B_sk, m~] (the sum over i of [x_i m~ (Q/q_i)^-1]_{q_i}
  (Q/q_i), which is x + a_x Q with a_x in [0, L - 1], not an exact CRT),
  then the Montgomery correction by m~ = 2^16 or 2^32.
* behz_tensor_mac: la, lb [..., K, 2, M, N] (Eval over the M = 2L + 1
  moduli of [q, B_sk]) -> [..., 3, M, N]: p0 = sum a0 b0, p1 = sum
  (a0 b1 + a1 b0), p2 = sum a1 b1 over the K pairs at `axis` (or one
  pair where axis is None), each times `scale` mod its modulus (t, so
  the product is scaled once; 1 leaves it unscaled).
* behz_floor: y [..., L + L_bsk, N] over [q, B_sk] (Coeff) -> floor(x/q)
  over q (Shenoy-Kumaresan with m_sk centring), after each row is
  multiplied by `scale` mod its modulus (1: none). The inverse NTT is
  linear, so a scale here equals the scale before it bit for bit.
"""

from __future__ import annotations

import torch

from .. import trace
from ..core import poly as polymod
from ..core.poly import COEFF, PolyRq
from . import behz_cuda
from . import modarith as ma


def _count_plain(name: str, x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        trace.count("plain_on_cuda." + name)


def _route(name: str, x: torch.Tensor, kernel, plain):
    if x.device.type == "cuda":
        return kernel()
    if x.device.type == "cpu":
        return plain()
    raise ValueError(f"no {name} for device {x.device}")


def _scale_rows(x: torch.Tensor, ctx, scale: int) -> torch.Tensor:
    """x [..., L, N] over ctx, row i times scale mod q_i."""
    if scale == 1:
        return x
    return polymod.mul_scalar_rows(PolyRq(x, ctx, COEFF), [scale] * len(ctx.moduli)).data


# -- plain versions -----------------------------------------------------------


def behz_lift_plain(x: torch.Tensor, tool) -> torch.Tensor:
    """x [..., L, N] over q (Coeff) -> [..., L + L_bsk, N] over [q, B_sk]."""
    _count_plain("behz_lift", x)
    bsk = tool.small_montgomery_reduce(tool.convert_approximate_bsk_mtilde(x))
    return torch.cat((x, bsk), dim=-2)


def behz_tensor_mac_plain(la: torch.Tensor, lb: torch.Tensor, ext_ctx, scale: int = 1,
                          axis: int | None = None) -> torch.Tensor:
    """la, lb [..., K, 2, M, N] (K at `axis`; absent where None) ->
    [..., 3, M, N]."""
    _count_plain("behz_tensor_mac", la)
    q = ext_ctx.q_col
    a0, a1 = la.select(-3, 0), la.select(-3, 1)
    b0, b1 = lb.select(-3, 0), lb.select(-3, 1)
    p1 = ma.add_mod(ma.mul_mod(a0, b1, q), ma.mul_mod(a1, b0, q), q)
    out = torch.stack((ma.mul_mod(a0, b0, q), p1, ma.mul_mod(a1, b1, q)), dim=-3)
    if axis is not None:
        out = ma.sum_mod(out, q, axis)
    return _scale_rows(out, ext_ctx, scale)


def behz_floor_plain(y: torch.Tensor, tool, scale: int = 1) -> torch.Tensor:
    """y [..., L + L_bsk, N] over [q, B_sk] (Coeff) -> [..., L, N] over q."""
    _count_plain("behz_floor", y)
    y = _scale_rows(y, tool.q_bsk_context, scale)
    return tool.convert_approximate_bsk_to_q(tool.approximate_floor(y))


# -- dispatch -----------------------------------------------------------------


def behz_lift(x: torch.Tensor, tool) -> torch.Tensor:
    return _route("behz_lift", x,
                  lambda: behz_cuda.behz_lift(x, tool.input_context.moduli, tool.bsk_context.moduli, tool.m_tilde),
                  lambda: behz_lift_plain(x, tool))


def _mac_operands(la: torch.Tensor, lb: torch.Tensor, axis: int | None):
    """la and lb as the kernel takes them: one shape [..., K, 2, M, N],
    contiguous (a copy only where the caller's layout differs)."""
    if la.shape != lb.shape:
        la, lb = torch.broadcast_tensors(la, lb)
    if axis is None:
        la, lb = la.unsqueeze(-4), lb.unsqueeze(-4)
    else:
        la, lb = la.movedim(axis, -4), lb.movedim(axis, -4)
    return la.contiguous(), lb.contiguous()


def behz_tensor_mac(la: torch.Tensor, lb: torch.Tensor, ext_ctx, scale: int = 1,
                    axis: int | None = None) -> torch.Tensor:
    return _route("behz_tensor_mac", la,
                  lambda: behz_cuda.behz_tensor_mac(*_mac_operands(la, lb, axis), ext_ctx.moduli, scale),
                  lambda: behz_tensor_mac_plain(la, lb, ext_ctx, scale, axis))


def behz_floor(y: torch.Tensor, tool, scale: int = 1) -> torch.Tensor:
    return _route("behz_floor", y,
                  lambda: behz_cuda.behz_floor(y, tool.input_context.moduli, tool.bsk_context.moduli, scale),
                  lambda: behz_floor_plain(y, tool, scale))
