"""The port's numpy AES-128 CTR_DRBG and samplers against she_tpu.rng.

Exact equality throughout: seeded `a` polynomials, keys and errors must
consume the same byte streams in the same order in both packages.
"""

import numpy as np
import pytest

from she_tpu.rng import ctr_drbg as jdrbg
from she_tpu.rng import sampling as jsampling
from she_tpu_torch.rng import ctr_drbg as tdrbg
from she_tpu_torch.rng import sampling as tsampling

SEEDS = [bytes(range(32)), b"\xff" * 32, bytes(np.random.default_rng(3).integers(0, 256, 32, dtype=np.uint8))]
MODULI = [(1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727]


def test_aes128_fips197_vector():
    """FIPS-197 Appendix C.1 known answer."""
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    block = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"), dtype=np.uint8)
    out = tdrbg.aes_encrypt_blocks(key, block[None, :])
    assert out.tobytes().hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_aes192_fips197_vector():
    """FIPS-197 Appendix C.2 known answer: the 24-byte key schedule that
    AES-GCM's Symmetric PIR keys use."""
    key = bytes(range(24))
    block = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"), dtype=np.uint8)
    out = tdrbg.aes_encrypt_blocks(key, block[None, :])
    assert out.tobytes().hex() == "dda97ca4864cdfe06eaf70a0ec0d7191"
    with pytest.raises(ValueError):
        tdrbg.aes_encrypt_blocks(bytes(32), block[None, :])


def test_drbg_vector_with_intermediate_state():
    """The first CAVP vector of tests/test_drbg.py, with its key/V states."""
    entropy = bytes.fromhex("69a09f6bf5dda15cd4af29e14cf5e0cddd7d07ac39bba587f8bc331104f9c448")
    expected = bytes.fromhex(
        "f78a4919a6ec899f7b6c69381febbbe083315f3d289e70346db0e4ec4360473a"
        "e0b3d916e9b6b964309f753ed66ae59de48da316cc1944bc8dfd0e2575d0ff6d"
    )
    prng = tdrbg.NistCtrDrbg(entropy)
    assert prng.key.hex() == "314263a50fa3913de2d034b6e812a597"
    prng.generate(len(expected))
    assert prng.key.hex() == "4b0f2ae7d0b330fa709b0844c7eedb5c"
    assert prng.generate(len(expected)) == expected


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lengths", [(1, 15, 4080, 1000), (4096, 4096, 3), (65536,)])
def test_buffered_stream_matches_she_tpu(seed, lengths):
    got = tdrbg.nist_aes128_ctr(seed)
    want = jdrbg.nist_aes128_ctr(seed)
    for n in lengths:
        assert got.random_bytes(n) == want.random_bytes(n)
    assert got.next_u64() == want.next_u64()
    assert got.next_u32() == want.next_u32()


def test_counter_wraps_like_she_tpu():
    """A V near 2^128 carries across the 64-bit halves of the counter."""
    for v in ((1 << 64) - 2, (1 << 128) - 3):
        got = tdrbg._aes_ctr_keystream(b"k" * 16, v, 80)
        want = jdrbg._aes_ctr_keystream(b"k" * 16, v, 80)
        assert got == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("degree", [8, 2048])
def test_samplers_match_she_tpu(seed, degree):
    moduli = MODULI[:2]
    u_t = tsampling.sample_uniform(tdrbg.nist_aes128_ctr(seed), moduli, degree)
    u_j = jsampling.sample_uniform(jdrbg.nist_aes128_ctr(seed), moduli, degree)
    np.testing.assert_array_equal(u_t, u_j.astype(np.int64))
    t_rng, j_rng = tdrbg.nist_aes128_ctr(seed), jdrbg.nist_aes128_ctr(seed)
    np.testing.assert_array_equal(
        tsampling.sample_ternary(t_rng, moduli, degree),
        jsampling.sample_ternary(j_rng, moduli, degree).astype(np.int64),
    )
    # the CBD draw continues the same stream
    np.testing.assert_array_equal(
        tsampling.sample_centered_binomial(t_rng, moduli, degree, 3.2),
        jsampling.sample_centered_binomial(j_rng, moduli, degree, 3.2).astype(np.int64),
    )
    assert t_rng.random_bytes(7) == j_rng.random_bytes(7)


def test_uniform_wide_modulus_matches_she_tpu():
    moduli = [(1 << 55) - 311295]
    u_t = tsampling.sample_uniform(tdrbg.nist_aes128_ctr(SEEDS[0]), moduli, 16)
    u_j = jsampling.sample_uniform(jdrbg.nist_aes128_ctr(SEEDS[0]), moduli, 16)
    assert u_t.tolist() == u_j.tolist()
