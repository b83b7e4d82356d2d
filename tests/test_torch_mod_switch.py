"""The mod switch (ops/key_switch.mod_switch under bfv.mod_switch_down and
mod_switch_down_to_single) against she_tpu, bit for bit, on the CPU.

Ciphertexts from numpy generators with fixed seeds, over the five moduli
of insecure_n_8_logq_5x18_logt_5 (at 32 and 64 bits) and over five
55-62-bit NTT primes at N = 256, go through she_tpu's mod_switch_down /
mod_switch_down_to_single (core/poly.py:207 divide_and_round_q_last once
a drop) and the port's, from 5 moduli to 1 and to 4 and from 2 to 1;
batched polys go through one port call and she_tpu's per entry. The
kernel's per-drop constants are checked against Python integers, and the
refusals against she_tpu's: a ciphertext not in Coeff format and a drop
below one modulus. The kernel itself is held to the plain version on the
card by tests/test_torch_key_switch_kernels.py. Every comparison is exact
(tolerance 0).
"""

import numpy as np
import pytest
import torch

from she_tpu import errors as jerrors
from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.core import context as jctxmod
from she_tpu.core import poly as jpoly
from she_tpu.ops import word as wordmod
from she_tpu_torch import errors as terrors
from she_tpu_torch import params as tparams
from she_tpu_torch import trace
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.core import context as tctxmod
from she_tpu_torch.core.poly import COEFF, EVAL, PolyRq
from she_tpu_torch.ops import key_switch as ks
from she_tpu_torch.ops import key_switch_cuda as kc
from she_tpu_torch.utils import nt

torch.set_num_threads(1)

PARAMS = "insecure_n_8_logq_5x18_logt_5"
CPU = torch.device("cpu")
# near 2^62 and 2^55, the last above the others (its half mod q_i wraps)
BIG = tuple(nt.generate_primes([55, 62, 60, 61, 62], preferring_small=False, ntt_degree=256))


def _moduli(bits):
    return tuple(tparams.from_predefined(PARAMS, bits).coefficient_moduli)


def _rand(moduli, batch, degree, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        out[..., i, :] = rng.integers(0, q, size=tuple(batch) + (degree,), dtype=np.int64)
    half = moduli[-1] // 2
    out[..., :, :4] = [[0, q - 1, half % q, (half + 1) % q] for q in moduli]  # the rounding's edges
    return out


def _contexts(bits, moduli, degree):
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    return (jctx, jctxmod.get_poly_context(degree, moduli, bits),
            tctx, tctxmod.get_poly_context(degree, moduli, bits, CPU))


def _ciphertexts(bits, moduli, degree, batch, seed):
    """The same 2-poly Coeff ciphertexts over `moduli` in both packages:
    she_tpu's one per batch entry, the port's one with the batch axes."""
    jctx, jpctx, tctx, tpctx = _contexts(bits, moduli, degree)
    values = _rand(moduli, tuple(batch) + (2,), degree, seed)
    flat = values.reshape((-1, 2) + values.shape[-2:])
    jcts = [jbfv.Ciphertext(jctx, [jpoly.PolyRq.from_values(v[p].astype(object), jpctx, jpoly.COEFF) for p in range(2)])
            for v in flat]
    data = torch.from_numpy(values)
    tct = tbfv.Ciphertext(tctx, [PolyRq(data[..., p, :, :], tpctx, COEFF) for p in range(2)])
    return jcts, tct


def _jv(poly) -> np.ndarray:
    return wordmod.unpack(np.asarray(poly.data)).astype(np.int64)


def _assert_equal(tct, jcts, batch):
    assert tct.moduli_count == jcts[0].moduli_count
    for p in range(2):
        got = tct.polys[p].data.reshape((-1,) + tuple(tct.polys[p].data.shape[-2:])).numpy()
        want = np.stack([_jv(j.polys[p]) for j in jcts])
        np.testing.assert_array_equal(got, want)
        assert tct.polys[p].context.moduli == jcts[0].polys[p].context.moduli
        assert tuple(tct.polys[p].data.shape[:-2]) == tuple(batch)


CASES = [(5, 1), (5, 4), (2, 1)]


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("count,target", CASES)
def test_mod_switch_matches_she_tpu(bits, count, target):
    """L -> target by mod_switch_down (target 4: one drop) or
    mod_switch_down_to_single (target 1: every drop in one call), two
    ciphertexts batched in the port."""
    moduli = _moduli(bits)[:count]
    jcts, tct = _ciphertexts(bits, moduli, 8, (2,), seed=10 * count + bits)
    if target == 1:
        got, want = tbfv.mod_switch_down_to_single(tct), [jbfv.mod_switch_down_to_single(j) for j in jcts]
    else:
        got, want = tbfv.mod_switch_down(tct), [jbfv.mod_switch_down(j) for j in jcts]
    _assert_equal(got, want, (2,))
    if count == 2:  # one drop: both functions are the same
        _assert_equal(tbfv.mod_switch_down(tct), want, (2,))


@pytest.mark.parametrize("count,target", CASES)
def test_mod_switch_at_n256_matches_she_tpu(count, target):
    """N = 256 at 55-62-bit moduli, where q_last's half wraps mod the
    smaller moduli, through the dispatch of several drops at once."""
    moduli = BIG[:count]
    jcts, tct = _ciphertexts(64, moduli, 256, (), seed=count + target)
    want = jcts[0]
    while want.moduli_count > target:
        want = jbfv.mod_switch_down(want)
    tctx = tct.poly_context()
    got = ks.mod_switch(tbfv.stacked_view(tct), tctx, target)
    np.testing.assert_array_equal(got.numpy(), np.stack([_jv(p) for p in want.polys]))


def test_mod_switch_down_to_single_is_one_dispatch():
    """Every drop of every poly in one mod_switch: the tracer's registry
    counts one mod_switch, and a ciphertext already at one modulus is returned as it
    is, with no run."""
    moduli = _moduli(32)
    _, tct = _ciphertexts(32, moduli, 8, (3,), seed=5)
    before = trace.counters["mod_switch"]
    single = tbfv.mod_switch_down_to_single(tct)
    assert trace.counters["mod_switch"] == before + 1
    assert single.moduli_count == 1 and tbfv.mod_switch_down_to_single(single) is single
    assert trace.counters["mod_switch"] == before + 1


@pytest.mark.parametrize("count,target", CASES + [(8, 3)])
def test_mod_switch_constants(count, target):
    """The kernel's per-drop constants: for each drop d (q_d dropped, from
    L - 1 down to target), d + 1 rows; row i < d holds q_i,
    floor(2^128 / q_i) as two words, floor(q_d / 2) mod q_i,
    q_d^-1 mod q_i and floor(q_d^-1 * 2^64 / q_i); row d holds q_d's."""
    moduli = tuple(nt.generate_primes([62, 55, 61, 50, 62, 58, 60, 62], preferring_small=False, ntt_degree=8))[:count]
    table = kc.mod_switch_constants(moduli, target, CPU).numpy().astype(np.uint64)
    rows = iter(table)
    for d in range(count - 1, target - 1, -1):
        for i in range(d + 1):
            row = [int(v) for v in next(rows)]
            q = moduli[i]
            ratio = (1 << 128) // q
            assert row[:3] == [q, ratio % (1 << 64), ratio >> 64]
            if i < d:
                inv = pow(moduli[d], -1, q)
                assert row[3:6] == [(moduli[d] // 2) % q, inv, (inv << 64) // q]
    assert next(rows, None) is None


def test_mod_switch_refuses_what_she_tpu_refuses():
    """Eval format and a drop below one modulus, as she_tpu refuses them."""
    moduli = _moduli(32)
    jcts, tct = _ciphertexts(32, moduli[:2], 8, (), seed=7)
    jeval = jbfv.Ciphertext(jcts[0].context, [jpoly.PolyRq(p.data, p.context, jpoly.EVAL) for p in jcts[0].polys])
    teval = tbfv.Ciphertext(tct.context, [PolyRq(p.data, p.context, EVAL) for p in tct.polys])
    for jfn, tfn in ((jbfv.mod_switch_down, tbfv.mod_switch_down),
                     (jbfv.mod_switch_down_to_single, tbfv.mod_switch_down_to_single)):
        with pytest.raises(jerrors.InvalidFormat):
            jfn(jeval)
        with pytest.raises(terrors.InvalidFormat):
            tfn(teval)
    jone, tone = jbfv.mod_switch_down(jcts[0]), tbfv.mod_switch_down(tct)
    with pytest.raises(jerrors.InvalidCiphertext):
        jbfv.mod_switch_down(jone)
    with pytest.raises(terrors.InvalidCiphertext):
        tbfv.mod_switch_down(tone)


@pytest.mark.parametrize("target", [0, 2, 3])
def test_dispatch_refuses_other_targets(target):
    """A mod switch goes to 1 or more fewer moduli, on both routes."""
    ctx = tctxmod.get_poly_context(8, _moduli(32)[:2], 32, CPU)
    x = torch.from_numpy(_rand(ctx.moduli, (2,), 8, 1))
    with pytest.raises(ValueError):
        ks.mod_switch(x, ctx, target)
    with pytest.raises(ValueError):
        ks.mod_switch_plain(x, ctx, target)


def test_wrapper_and_dispatch_refuse():
    """The CUDA wrapper takes only CUDA int64 tensors and at most
    MAX_MOD_SWITCH_MODULI moduli; the dispatch no other device."""
    moduli = _moduli(32)[:2]
    x = torch.from_numpy(_rand(moduli, (2,), 8, 2))
    with pytest.raises(ValueError):
        kc.mod_switch(x, moduli, 1)
    with pytest.raises(TypeError):
        kc.mod_switch(x.to(torch.int32), moduli, 1)
    many = tuple(nt.generate_primes([30] * 9, preferring_small=False, ntt_degree=8))
    with pytest.raises(ValueError):
        kc._mod_switch_launch((2, 9, 8), (72, 8, 1), many, 1)
    ctx = tctxmod.get_poly_context(8, moduli, 32, CPU)
    with pytest.raises(ValueError):
        ks.mod_switch(x.to("meta"), ctx, 1)
