"""RNS machinery: approximate base conversion and the BEHZ tool.

The port of she_tpu/core/rns.py (and the reference's _RnsBaseConverter /
_RnsTool, RnsBaseConverter.swift:14-144, RnsTool.swift:18-475). Constants
are precomputed on the host with Python big ints; the device path is
modular multiply-adds over int64 [..., L, N] tensors through ops/modarith,
whose lazy sums are bounded by modarith.lazy_product_count: the int64
route at 32-bit scalars, the exact wide route (ops/wide.py) at 64 bits,
where m~ = 2^32, gamma = 2^62 - 40797 and 61-bit B_sk primes make every
conversion wide. Every step is exact modular arithmetic, so fully reduced
results equal she_tpu's bit for bit.

As in she_tpu, every level gets a consistent [B_level, m_sk, m~] base drawn
from one shared B_sk prime pool.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import modarith as ma
from ..utils import nt
from .context import PolyContext, get_poly_context


def mul_mod_power_of_two(r: torch.Tensor, c: int, m: int) -> torch.Tensor:
    """r * c mod m for r, c in [0, m), m = 2^k, without overflow: one
    product while (m-1)^2 fits int64, else with c split at k/2 bits, so each
    partial product stays below 2^(3k/2)."""
    mask = m - 1
    if (m - 1) ** 2 < ma.INT63:
        return (r * c) & mask
    half = (m.bit_length() - 1) // 2
    c_lo, c_hi = c & ((1 << half) - 1), c >> half
    return (r * c_lo + (((r * c_hi) & ((1 << (m.bit_length() - 1 - half)) - 1)) << half)) & mask


class RnsBaseConverter:
    """Approximate base conversion q -> t (eprint 2016/510 Eq. 2).

    Output coefficients are (x + a_x * q) mod t_j with a_x in [0, L-1].
    """

    def __init__(self, input_context: PolyContext, output_context: PolyContext):
        if input_context.degree != output_context.degree:
            raise ValueError("base conversion between different degrees")
        self.input_context = input_context
        self.output_context = output_context
        in_moduli = input_context.moduli
        out_moduli = output_context.moduli
        Q = input_context.q_product
        # (q / q_i) mod t_j  [rows: t_j, cols: q_i]
        self.punctured = [[(Q // qi) % tj for qi in in_moduli] for tj in out_moduli]
        self.punctured_cols = [
            output_context.column(row[i] for row in self.punctured) for i in range(len(in_moduli))
        ]  # per q_i: [L_out, 1]
        # (q/q_i)^{-1} mod q_i
        self.inv_punctured = input_context.column(
            nt.inverse_mod((Q // qi) % qi, qi) for qi in in_moduli
        )
        # products of an input residue and an output constant
        self.bound = max(in_moduli + out_moduli)
        self.cap = ma.lazy_product_count(in_moduli + out_moduli)

    def convert_approximate_products(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., L_in, N] -> scaled products x_i * (q/q_i)^{-1} mod q_i."""
        return ma.mul_mod(x, self.inv_punctured, self.input_context.q_col)

    def convert_approximate_using(self, products: torch.Tensor) -> torch.Tensor:
        """products: [..., L_in, N] -> [..., L_out, N] in the output base."""
        terms = (
            (products[..., i : i + 1, :], self.punctured_cols[i])
            for i in range(len(self.input_context.moduli))
        )
        return ma.sum_products_mod(terms, self.output_context.q_col, self.cap, self.bound)

    def convert_approximate(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., L_in, N] coeff -> [..., L_out, N]."""
        return self.convert_approximate_using(self.convert_approximate_products(x))

    def crt_compose(self, values: np.ndarray) -> np.ndarray:
        """Host-exact CRT composition: integer array [L, N] -> [N] ints in [0, Q)."""
        Q = self.input_context.q_product
        moduli = self.input_context.moduli
        values = np.asarray(values).astype(object)
        out = np.zeros(values.shape[1], dtype=object)
        for i, qi in enumerate(moduli):
            gi = Q // qi
            inv = nt.inverse_mod(gi % qi, qi)
            out += (values[i] * inv % qi) * gi
        return out % Q


@lru_cache(maxsize=None)
def bsk_prime_pool(degree: int, top_moduli_count: int, scalar_bits: int) -> tuple[int, ...]:
    """Shared B_sk prime pool: top_moduli_count+1 primes of (bits-3) bits,
    preferring small, NTT-friendly (reference RnsTool.swift:29-36)."""
    bits = scalar_bits
    return tuple(
        nt.generate_primes(
            [bits - 3] * (top_moduli_count + 1),
            preferring_small=True,
            ntt_degree=degree,
            bit_width=bits,
        )
    )


class RnsTool:
    """Per-level BEHZ tool (eprint 2016/510): input base q = q_0..q_{L-1},
    output modulus t, auxiliary base B_sk = [B, m_sk] plus m~."""

    def __init__(self, input_context: PolyContext, t: int, bsk_pool: tuple[int, ...]):
        self.input_context = input_context
        self.t = t
        bits = input_context.scalar_bits
        degree = input_context.degree
        dev = input_context.device
        L = len(input_context.moduli)
        self.gamma = (1 << 30) - 20405 if bits == 32 else (1 << 62) - 40797
        self.m_tilde = 1 << 16 if bits == 32 else 1 << 32

        self.output_context = get_poly_context(degree, (t,), bits, dev)
        self.t_gamma_context = get_poly_context(degree, (t, self.gamma), bits, dev)

        bsk_moduli = bsk_pool[: L + 1]
        self.bsk_context = get_poly_context(degree, bsk_moduli, bits, dev)
        self.b_context = get_poly_context(degree, bsk_moduli[:-1], bits, dev)
        self.m_sk = bsk_moduli[-1]
        self.bsk_mtilde_context = get_poly_context(
            degree, bsk_moduli + (self.m_tilde,), bits, dev
        )
        self.q_bsk_context = get_poly_context(
            degree, input_context.moduli + bsk_moduli, bits, dev
        )

        Q = input_context.q_product
        B = self.b_context.q_product
        self.q_mod_t = Q % t
        self.t_threshold = (t + 1) // 2
        gamma_t = self.gamma * t
        self.prod_gamma_t_mod_q = [gamma_t % qi for qi in input_context.moduli]
        self.inverse_gamma_mod_t = nt.inverse_mod(self.gamma % t, t)
        self.neg_inverse_q_mod_t_gamma = self.t_gamma_context.column(
            (-nt.inverse_mod(Q % m, m)) % m for m in (t, self.gamma)
        )
        self.neg_inverse_q_mod_m_tilde = (-nt.inverse_mod(Q % self.m_tilde, self.m_tilde)) % self.m_tilde
        self.q_div_t = [(Q // t) % qi for qi in input_context.moduli]
        self.m_tilde_mod_q = [self.m_tilde % qi for qi in input_context.moduli]
        bctx = self.bsk_context
        self.q_mod_bsk = bctx.column(Q % m for m in bsk_moduli)
        self.inverse_m_tilde_mod_bsk = bctx.column(
            nt.inverse_mod(self.m_tilde % m, m) for m in bsk_moduli
        )
        self.inverse_q_mod_bsk = bctx.column(nt.inverse_mod(Q % m, m) for m in bsk_moduli)
        self.inverse_b_mod_m_sk = nt.inverse_mod(B % self.m_sk, self.m_sk)
        self.b_mod_q = input_context.column(B % qi for qi in input_context.moduli)
        self.neg_b_mod_q = input_context.column((-B) % qi for qi in input_context.moduli)

        self.convert_q_to_t_gamma = RnsBaseConverter(input_context, self.t_gamma_context)
        self.convert_q_to_bsk = RnsBaseConverter(input_context, self.bsk_context)
        self.convert_q_to_bsk_mtilde = RnsBaseConverter(input_context, self.bsk_mtilde_context)
        self.convert_b_to_m_sk = RnsBaseConverter(
            self.b_context, get_poly_context(degree, (self.m_sk,), bits, dev)
        )
        self.convert_b_to_q = RnsBaseConverter(self.b_context, input_context)

    # -- decryption scaling -------------------------------------------------

    def scale_and_round(self, x: torch.Tensor, scaling_factor: int) -> torch.Tensor:
        """BEHZ Alg 2 decryption scaling (RnsTool.swift:272-302).

        x: [..., L, N] coeff holding Delta*m + v; returns [..., 1, N] mod t.
        """
        ctx = self.input_context
        t = self.t
        y = ma.mul_mod(x, ctx.column(self.prod_gamma_t_mod_q), ctx.q_col)
        z = self.convert_q_to_t_gamma.convert_approximate(y)
        z = ma.mul_mod(z, self.neg_inverse_q_mod_t_gamma, self.t_gamma_context.q_col)
        poly_mod_t, poly_mod_gamma = z[..., 0:1, :], z[..., 1:2, :]
        exceeds = poly_mod_gamma > self.gamma // 2
        s_greater = ma.neg_mod(torch.remainder(self.gamma - poly_mod_gamma, t), t)
        s_less = torch.remainder(poly_mod_gamma, t)
        s_gamma = torch.where(exceeds, s_greater, s_less)
        result = ma.sub_mod(poly_mod_t, s_gamma, t)
        c = (self.inverse_gamma_mod_t * (scaling_factor % t)) % t
        return ma.mul_mod(result, c, t)

    # -- BEHZ ct-ct multiply machinery (eprint 2016/510) --------------------

    def convert_approximate_bsk_mtilde(self, x: torch.Tensor) -> torch.Tensor:
        """Alg 1: x*m~ mod q, approximately converted to [B_sk, m~]
        (RnsTool.swift:313-316). x: [..., L, N] coeff."""
        ctx = self.input_context
        scaled = ma.mul_mod(x, ctx.column(self.m_tilde_mod_q), ctx.q_col)
        return self.convert_q_to_bsk_mtilde.convert_approximate(scaled)

    def small_montgomery_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Montgomery correction: [..., L_bsk+1, N] over [B_sk, m~] ->
        [..., L_bsk, N] over B_sk, multiplied by m~^{-1}
        (RnsTool.swift:339-368)."""
        bctx = self.bsk_context
        L_bsk = len(bctx.moduli)
        m_tilde = self.m_tilde
        r = y[..., L_bsk : L_bsk + 1, :]  # m~ row, in [0, m~)
        # r_mtilde = -(Q^{-1}) * r mod m~ (m~ is a power of two)
        r_mtilde = mul_mod_power_of_two(r, self.neg_inverse_q_mod_m_tilde, m_tilde)
        # centered: r_mtilde - m~ if r_mtilde >= m~/2, represented mod bsk
        rm = torch.where(
            r_mtilde < (m_tilde >> 1), r_mtilde, r_mtilde + bctx.q_col - m_tilde
        )
        qb = bctx.q_col
        acc = ma.add_mod(y[..., :L_bsk, :], ma.mul_mod(rm, self.q_mod_bsk, qb), qb)
        return ma.mul_mod(acc, self.inverse_m_tilde_mod_bsk, qb)

    def lift_q_to_qbsk(self, x: torch.Tensor) -> torch.Tensor:
        """Alg 2: [..., L, N] over q -> [..., L + L_bsk, N] over [q, B_sk]
        (RnsTool.swift:324-331)."""
        bsk = self.small_montgomery_reduce(self.convert_approximate_bsk_mtilde(x))
        return torch.cat((x, bsk), dim=-2)

    def approximate_floor(self, y: torch.Tensor) -> torch.Tensor:
        """Uncorrected RNS floor: [..., L + L_bsk, N] over [q, B_sk] ->
        [..., L_bsk, N] = floor(x/q) + a_x over B_sk (RnsTool.swift:378-398)."""
        L = len(self.input_context.moduli)
        qb = self.bsk_context.q_col
        conv = self.convert_q_to_bsk.convert_approximate(y[..., :L, :])
        diff = ma.sub_mod(y[..., L:, :], conv, qb)
        return ma.mul_mod(diff, self.inverse_q_mod_bsk, qb)

    def convert_approximate_bsk_to_q(self, y: torch.Tensor) -> torch.Tensor:
        """Shenoy-Kumaresan with m_sk centering: [..., L_bsk, N] over B_sk ->
        [..., L, N] over q (RnsTool.swift:402-450)."""
        ctx = self.input_context
        L_b = len(self.b_context.moduli)
        x_b = y[..., :L_b, :]
        x_msk = y[..., L_b:, :]  # [..., 1, N]
        m_sk = self.m_sk
        alpha = self.convert_b_to_m_sk.convert_approximate(x_b)
        # alpha = B^{-1} * (alpha - x_msk) mod m_sk
        alpha = ma.mul_mod(ma.sub_mod(alpha, x_msk, m_sk), self.inverse_b_mod_m_sk, m_sk)
        exceeds = alpha > (m_sk >> 1)
        out = self.convert_b_to_q.convert_approximate(x_b)
        q = ctx.q_col
        # alpha and m_sk - alpha are below m_sk, which may exceed q
        adj_gt = ma.mul_mod(m_sk - alpha, self.b_mod_q, q, bound=m_sk + 1)
        adj_le = ma.mul_mod(alpha, self.neg_b_mod_q, q, bound=m_sk)
        return ma.add_mod(out, torch.where(exceeds, adj_gt, adj_le), q)

    def floor_qbsk_to_q(self, y: torch.Tensor) -> torch.Tensor:
        """[..., L + L_bsk, N] over [q, B_sk] -> floor(x/q) over q
        (RnsTool.swift:453-456)."""
        return self.convert_approximate_bsk_to_q(self.approximate_floor(y))

    # -- host helpers -------------------------------------------------------

    def crt_compose(self, values: np.ndarray) -> np.ndarray:
        return self.convert_q_to_bsk.crt_compose(values)
