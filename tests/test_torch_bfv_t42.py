"""Encryption at a plaintext modulus t >= 2^31 against she_tpu, bit for bit.

At n_8192_logq_3x55_logt_42 (64-bit scalars, t = 2^41 + 32769) the
rounding term floor((qModT * m + t/2) / t) of the plaintext translate needs
up to 84 bits; the port computes it on the wide route (ops/wide.py
mul_wide and divmod_pair). One ciphertext from the same DRBG seeds must
equal she_tpu's, and decrypt to its values. Tolerance 0.
"""

import numpy as np
import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

PARAMS = "n_8192_logq_3x55_logt_42"


def _seed(tag):
    return (tag * 32)[:32]


@pytest.fixture(scope="module")
def both():
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 64))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 64), device="cpu")
    t = tctx.plaintext_modulus
    assert t >= 1 << 31
    rng = np.random.default_rng(42)
    values = [int(v) for v in rng.integers(0, t, size=tctx.degree)]
    values[:4] = [0, 1, t - 1, t // 2]  # the ends of the range and the rounding threshold
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    tsk = tbfv.generate_secret_key(tctx, trng(_seed(b"s")))
    jct = jbfv.encrypt(jbfv.encode(jctx, values), jsk, seed=_seed(b"c"), err_rng=jrng(_seed(b"e")))
    tct = tbfv.encrypt(tbfv.encode(tctx, values), tsk, seed=_seed(b"c"), err_rng=trng(_seed(b"e")))
    return dict(tctx=tctx, tsk=tsk, jct=jct, tct=tct, values=values)


def test_ciphertext_bits_match_she_tpu(both):
    got = convert.ciphertext_to_limbs(both["tct"])
    want = [np.asarray(p.data) for p in both["jct"].polys]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_decrypts_to_its_values(both):
    assert tbfv.decode(both["tctx"], tbfv.decrypt(both["tct"], both["tsk"])) == both["values"]


@pytest.mark.parametrize("q", [(1 << 41) + 32769, (1 << 31) + 11, (1 << 62) - 57, 3])
def test_divmod_pair_is_exact(q):
    """wide.divmod_pair against Python integers over T = hi * 2^62 + lo,
    hi < q, at the edges and at random."""
    import torch

    from she_tpu_torch.ops import wide

    rng = np.random.default_rng(q % 1000)
    his = [0, q - 1, 0, q - 1] + [int(v) for v in rng.integers(0, q, size=60)]
    los = [0, 0, (1 << 62) - 1, (1 << 62) - 1] + [int(v) for v in rng.integers(0, 1 << 62, size=60)]
    quot, rem = wide.divmod_pair(torch.tensor(his), torch.tensor(los), q)
    want = [divmod(h * (1 << 62) + l, q) for h, l in zip(his, los)]
    assert quot.tolist() == [w[0] for w in want]
    assert rem.tolist() == [w[1] for w in want]
