"""The BEHZ kernels (csrc/behz.cu) against their plain PyTorch versions
(ops/behz.py), on the card, bit for bit.

Marked `gpu`: each test decides inside itself whether a card exists and
skips where there is none. This file imports only the port (no jax, no
she_tpu), so it also runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_behz_kernels.py

Moduli of three kinds: 27-28-bit (the w32 sets, m~ = 2^16, B_sk of 29
bits), 55-bit (the w64 set, m~ = 2^32, B_sk of 61 bits) and 60-62-bit ones,
where every q_i is at or above m_sk; N from 8 to 8192, L from 1 to 4, K
from 1 to 31 pairs (a MAC reduces every 7, so K = 8 and above cross a
reduction, and at 60-62 bits an unreduced sum would pass 2^128), zero,
q - 1 and random fills, the scale 1, t and a t above 2^31, the lift's and
the floor's input as a transposed view and as a block of columns, the
widest shapes that the keyword, w32 and w64 cells launch, and a whole
ct x ct product on the card against the same product on the CPU.
"""

import numpy as np
import pytest
import torch

from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv
from she_tpu_torch.core import rns
from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.ops import behz
from she_tpu_torch.ops import behz_cuda as bc
from she_tpu_torch.utils import nt

MODULI = {
    "w32": (((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727, (1 << 28) - 83967), 32),
    "w64": (tuple(nt.generate_primes([55] * 4, preferring_small=False, ntt_degree=8192)), 64),
    "w62": (tuple(nt.generate_primes([62, 60, 61, 62], preferring_small=False, ntt_degree=8192)), 64),
}
DEGREES = [8, 512, 4096, 8192]
FILLS = ["zero", "max", "random"]
SCALES = [1, 17, (1 << 41) + 32769]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(moduli, batch, degree, seed, fill="random"):
    rng = np.random.default_rng(seed)
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        if fill == "random":
            out[..., i, :] = rng.integers(0, q, size=tuple(batch) + (degree,), dtype=np.int64)
        elif fill == "max":
            out[..., i, :] = q - 1
    return torch.from_numpy(out).cuda()


def _tool(route, l_count, degree):
    moduli, bits = MODULI[route]
    q = moduli[:l_count]
    return rns.RnsTool(get_poly_context(degree, q, bits, torch.device("cuda")), 2,
                       rns.bsk_prime_pool(degree, l_count, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_count", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_behz_lift(route, degree, l_count, fill):
    _card()
    tool = _tool(route, l_count, degree)
    q, bsk = tool.input_context.moduli, tool.bsk_context.moduli
    base = _rows(q, (3, 2), degree, seed=degree + l_count, fill=fill)
    for x in (base, base.transpose(0, 1), base[..., degree // 2:]):  # contiguous, transposed, a column block
        before = bc.launches["behz_lift"]
        got = bc.behz_lift(x, q, bsk, tool.m_tilde)
        assert bc.launches["behz_lift"] == before + 1
        assert torch.equal(got, behz.behz_lift_plain(x, tool)), tuple(x.stride())


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_count", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_behz_floor(route, degree, l_count, fill):
    _card()
    tool = _tool(route, l_count, degree)
    q, bsk = tool.input_context.moduli, tool.bsk_context.moduli
    base = _rows(q + bsk, (2, 3), degree, seed=3 * degree + l_count, fill=fill)
    for scale in SCALES:
        for y in (base, base.transpose(0, 1)):
            got = bc.behz_floor(y, q, bsk, scale)
            assert torch.equal(got, behz.behz_floor_plain(y, tool, scale)), (scale, tuple(y.stride()))


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_count", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_behz_tensor_mac(route, degree, l_count, fill):
    _card()
    tool = _tool(route, l_count, degree)
    ext = tool.q_bsk_context
    for K in ((1, 7, 8, 15, 31) if degree <= 512 else (1, 8)):
        la = _rows(ext.moduli, (2, K, 2), degree, seed=5 * degree + K, fill=fill)
        lb = _rows(ext.moduli, (2, K, 2), degree, seed=7 * degree + K, fill="max" if fill == "max" else "random")
        for scale in SCALES:
            got = bc.behz_tensor_mac(la, lb, ext.moduli, scale)
            assert torch.equal(got, behz.behz_tensor_mac_plain(la, lb, ext, scale, -4)), (K, scale)


# the widest served launches: (batch, K pairs, route of the cell's moduli, degree)
SERVED = {"keyword": (128, 31, "n_4096_logq_27_28_28_logt_5", 32, 4096),
          "w32": (128, 9, "n_4096_logq_27_28_28_logt_5", 32, 4096),
          "w64": (128, 4, "n_8192_logq_3x55_logt_24", 64, 8192)}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SERVED))
def test_widest_served_product(cell):
    """A cell's widest launches: both sides lifted from the query's
    transposed view and the columns, the MAC scaled by t, the floor."""
    _card()
    B, K, params, bits, degree = SERVED[cell]
    ep = tparams.from_predefined(params, scalar_bits=bits)
    ctx = bfv.get_bfv_context(ep, device="cuda")
    tool = ctx.get_rns_tool(len(ctx.ciphertext_context.moduli))
    q, bsk, ext = tool.input_context.moduli, tool.bsk_context.moduli, tool.q_bsk_context
    rest = _rows(q, (K, B, 2), degree, seed=91)
    v0 = rest.transpose(0, 1)  # [B, K, 2, L, N] as fold_dimensions reads it
    lifted = bc.behz_lift(v0, q, bsk, tool.m_tilde)
    assert torch.equal(lifted, behz.behz_lift_plain(v0, tool))
    del lifted, rest, v0
    la = _rows(ext.moduli, (B, K, 2), degree, seed=92)
    lb = _rows(ext.moduli, (B, K, 2), degree, seed=93)
    t = ep.plaintext_modulus
    prod = bc.behz_tensor_mac(la, lb, ext.moduli, t)
    assert torch.equal(prod, behz.behz_tensor_mac_plain(la, lb, ext, t, -4))
    del la, lb
    y = _rows(ext.moduli, (B, 3), degree, seed=94)
    assert torch.equal(bc.behz_floor(y, q, bsk), behz.behz_floor_plain(y, tool))


@pytest.mark.gpu
@pytest.mark.parametrize("params,bits", [("insecure_n_8_logq_5x18_logt_5", 32), ("n_8192_logq_3x55_logt_24", 64),
                                         ("insecure_n_16_logq_60_logt_15", 64)])
def test_products_on_the_card_equal_the_cpu(params, bits):
    """ct_mul and an inner product of 9 pairs through the dispatch: on the
    card the three kernels launch and no plain BEHZ pass runs; the bits
    equal the same products on the CPU."""
    _card()
    ep = tparams.from_predefined(params, scalar_bits=bits)
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bfv.get_bfv_context(ep, device=device)
        ct_ctx = ctx.ciphertext_context
        values = _rows(ct_ctx.moduli, (2, 9, 2), ctx.degree, seed=95).to(device)
        lhs = bfv.Ciphertext.from_stacked(ctx, values[0], ct_ctx)
        rhs = bfv.Ciphertext.from_stacked(ctx, values[1], ct_ctx)
        before, plain = dict(bc.launches), dict(behz.plain_calls_on_cuda)
        one = bfv.ct_mul(bfv.Ciphertext.from_stacked(ctx, values[0, 0], ct_ctx),
                         bfv.Ciphertext.from_stacked(ctx, values[1, 0], ct_ctx))
        out[device] = [one.stacked().cpu(), bfv.inner_product_ct_ct_stacked(lhs, rhs).stacked().cpu()]
        launched = {k: bc.launches[k] - before[k] for k in bc.launches}
        if device == "cuda":
            assert launched == {"behz_lift": 4, "behz_tensor_mac": 2, "behz_floor": 2}
            assert behz.plain_calls_on_cuda == plain
        else:
            assert launched == dict.fromkeys(bc.launches, 0)
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got, want)
