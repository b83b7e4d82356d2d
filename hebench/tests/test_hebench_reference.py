"""The plain reference agrees with the port on the CPU, at
insecure_n_8_logq_5x18_logt_5 and at a 60-bit set."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from hebench import harness, inputs
from hebench.reference import bfv as refbfv
from hebench.reference import pir as refpir
from hebench.tests.conftest import TINY_SEED

SETS = [("insecure_n_8_logq_5x18_logt_5", 32), ("insecure_n_512_logq_4x60_logt_20", 64)]


def context(name: str, bits: int):
    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv

    return bfv.get_bfv_context(paramsmod.from_predefined(name, scalar_bits=bits), "cpu")


@pytest.mark.parametrize("name,bits", SETS)
def test_decryption_agrees_with_the_port(name, bits):
    from she_tpu_torch.bfv import bfv

    ctx = context(name, bits)
    n, t = ctx.degree, ctx.plaintext_modulus
    raw = inputs.secret_bytes(11, n)
    sk = bfv.generate_secret_key(ctx, inputs.FixedBytes(raw))
    rng = np.random.default_rng(5)
    slots = [(int(rng.integers(1, t)), sorted({int(x) for x in rng.integers(0, n, size=3)})) for _ in range(6)]
    data = inputs.encrypt_batch(ctx, sk, slots, 12)
    matrix = refbfv.negacyclic_matrix(refbfv.ternary_secret(raw, n), "cpu")
    for (value, where), stacked in zip(slots, data):
        ct = bfv.Ciphertext.from_stacked(ctx, stacked, ctx.ciphertext_context)
        want = np.asarray(bfv.decode(ctx, bfv.decrypt(ct, sk)))
        expected = np.zeros(n, dtype=np.int64)
        expected[where] = value
        assert np.array_equal(want, expected)
        single = bfv.mod_switch_down_to_single(ct).stacked()  # [2, 1, N]
        q = ctx.ciphertext_context.moduli[0]
        v = refbfv.dot_with_secret(single[0, 0][None], single[1, 0][None], matrix, q)
        plain, noise = refbfv.decrypt(v, q, t)
        assert np.array_equal(plain[0].numpy(), want)
        assert refbfv.noise_share(noise, q, t) < 0.5


def test_negacyclic_product_is_exact():
    n, q = 16, (1 << 61) - 1
    rng = np.random.default_rng(3)
    secret = rng.integers(-1, 2, size=n)
    c1 = rng.integers(0, q, size=(3, n), dtype=np.int64)
    c0 = rng.integers(0, q, size=(3, n), dtype=np.int64)
    got = refbfv.dot_with_secret(torch.as_tensor(c0), torch.as_tensor(c1), refbfv.negacyclic_matrix(secret, "cpu"), q)
    for a in range(3):
        for i in range(n):
            want = int(c0[a, i]) + sum(int(c1[a, j]) * int(secret[(i - j) % n]) * (1 if i >= j else -1) for j in range(n))
            assert int(got[a, i]) == want % q


def test_coefficient_packing_agrees_with_the_port():
    from she_tpu_torch.io import coeffs as coeffio

    rng = np.random.default_rng(2)
    for bits, degree in ((4, 4096), (23, 8192), (4, 8)):
        data = rng.integers(0, 256, size=degree * bits // 8 - 3, dtype=np.uint8).tobytes()
        m = refbfv.bytes_to_coefficients(data, bits, degree)
        port = coeffio.bytes_to_coefficients_rows(np.frombuffer(data, np.uint8)[None], bits, decode=False)[0]
        assert np.array_equal(m[: port.size], port) and not m[port.size :].any()
        assert refbfv.coefficients_to_bytes(m, bits) == coeffio.coefficients_to_bytes(m, bits)


def test_keyword_hash_and_bucket_agree_with_the_port():
    from she_tpu_torch.pir import keyword_pir as kp

    keyword, value = b"\x01\x02keyword", b"\x07"
    assert refpir.keyword_hash(keyword) == kp.keyword_hash(keyword).to_bytes(8, "little")
    bucket = kp.HashBucket([(kp.keyword_hash(b"other"), b"\x09\x09"), (kp.keyword_hash(keyword), value)]).serialize()
    assert refpir.find_value(b"\0\0" + bucket + b"\0", keyword) == value
    assert refpir.find_value(bucket, b"absent") is None


@pytest.mark.parametrize("cell", ["mulpir_tiny.b4", "keyword_tiny.b4"])
def test_answers_judged_by_the_reference_decrypt_as_the_port_decrypts(tiny_root, cell):
    """Every sampled answer of a tiny run: the reference's plaintext equals
    the port's decryption of it, and the run is correct."""
    from she_tpu_torch.bfv import bfv

    result, extra = harness.run_cell(tiny_root, cell, TINY_SEED, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    served = extra["served"]
    ctx = served.context
    sk = bfv.generate_secret_key(ctx, inputs.FixedBytes(served.secret))
    matrix = refbfv.negacyclic_matrix(refbfv.ternary_secret(served.secret, ctx.degree), "cpu")
    single = ctx.ciphertext_context.get_context(1)
    for _, answers in extra["answers"]:
        flat = answers.reshape(-1, 2, ctx.degree)
        v = refbfv.dot_with_secret(flat[:, 0], flat[:, 1], matrix, served.q)
        plain, _ = refbfv.decrypt(v, served.q, served.t)
        for row, ct in zip(plain, flat):
            port = bfv.decode(ctx, bfv.decrypt(bfv.Ciphertext.from_stacked(ctx, ct[:, None], single), sk))
            assert row.tolist() == list(port)
