"""The scheme-conformance matrix on the port: what
tests/test_conformance_matrix.py asserts on she_tpu, asserted on
she_tpu_torch over the same combos (every predefined parameter set at both
scalar widths where it supports 32-bit scalars; rotations and
relinearization at production N). This file takes the 32-bit combos,
test_torch_conformance_matrix64.py the 64-bit ones, so that a loadfile
split gives them two workers.

Each test runs under a route of the NTT: "kernel", the default dispatch
(the butterfly kernel on a card, its plain version on the CPU), or "mxu",
SHE_TPU_NTT_MXU=1 (the matrix NTT, ops/ntt_mxu.py). On the CPU every combo
runs the default route and the matrix route runs at the sets with
128 <= N <= 512, where its plain version is quick; the `gpu` cases run the
whole matrix on the card under both routes:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_conformance_matrix.py tests/test_torch_conformance_matrix64.py

The module imports only the port; the check of the combo lists against
she_tpu's imports she_tpu inside the test.
"""

import numpy as np
import pytest
import torch

from she_tpu_torch import params as paramsmod
from she_tpu_torch.bfv import bfv, keys
from she_tpu_torch.io import serialize as ser
from she_tpu_torch.ops import galois as galoismod
from she_tpu_torch.ops import ntt_mxu
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

ALL_COMBOS = [
    (name, bits)
    for name in paramsmod.PREDEFINED_RLWE_PARAMETERS
    for bits in (32, 64)
    if bits == 64 or paramsmod.predefined_supports_scalar32(name)
]
ROTATION_COMBOS = [
    (name, bits)
    for name, bits in ALL_COMBOS
    if paramsmod.PREDEFINED_RLWE_PARAMETERS[name].poly_degree >= 4096
]
ROUTES = ("kernel", "mxu")
CPU_MXU_DEGREES = (128, 512)  # the matrix route on the CPU: 128 <= N <= 512

_CTX_CACHE: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the wide route's elementwise passes gain
    about nothing from more threads alone, and beside other test workers
    their thread teams thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def combos(combo_list, bits):
    return [c for c in combo_list if c[1] == bits]


def cpu_cases(combo_list, bits):
    """(name, bits, route): every combo on the default route, and the
    matrix route where the set's N is in CPU_MXU_DEGREES' range."""
    out = []
    for name, b in combos(combo_list, bits):
        out.append((name, b, "kernel"))
        if CPU_MXU_DEGREES[0] <= paramsmod.PREDEFINED_RLWE_PARAMETERS[name].poly_degree <= CPU_MXU_DEGREES[1]:
            out.append((name, b, "mxu"))
    return out


def card_cases(combo_list, bits):
    return [(name, b, route) for name, b in combos(combo_list, bits) for route in ROUTES]


def case_ids(cases):
    return ["-".join(str(v) for v in case) for case in cases]


def set_route(monkeypatch, route):
    monkeypatch.setenv(ntt_mxu.ENV, "1" if route == "mxu" else "0")


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_ctx(name, bits, device):
    key = (name, bits, str(device))
    if key not in _CTX_CACHE:
        _CTX_CACHE[key] = bfv.get_bfv_context(paramsmod.from_predefined(name, scalar_bits=bits), device=device)
    return _CTX_CACHE[key]


def det_rng(tag: bytes):
    return nist_aes128_ctr((tag * 32)[:32])


def rand_values(ctx, seed=0):
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, ctx.plaintext_modulus, size=ctx.degree)]


def op_battery(name, bits, device):
    """encode/decode (unsigned and signed, coefficient and SIMD),
    encrypt/decrypt, ct +- ct, neg, ct +- pt, ct * pt, mod switch down to
    one modulus, multiply by a power of x, transparency: exact plaintext
    arithmetic mod t (she_tpu's test_scheme_op_battery)."""
    ctx = make_ctx(name, bits, device)
    t = ctx.plaintext_modulus
    vals = rand_values(ctx, seed=1)
    pvals = rand_values(ctx, seed=2)

    pt = bfv.encode(ctx, vals)
    assert bfv.decode(ctx, pt) == vals
    signed = [v - (t // 2) for v in rand_values(ctx, seed=3)]
    assert bfv.decode_signed(ctx, bfv.encode_signed(ctx, signed)) == signed
    if ctx.supports_simd_encoding:
        spt = bfv.encode(ctx, vals, fmt="simd")
        assert bfv.decode(ctx, spt, fmt="simd") == vals
        assert bfv.decode_signed(ctx, bfv.encode_signed(ctx, signed, fmt="simd"), fmt="simd") == signed

    sk = bfv.generate_secret_key(ctx, det_rng(b"s"))
    ct = bfv.encrypt(pt, sk, err_rng=det_rng(b"a"))
    assert bfv.decode(ctx, bfv.decrypt(ct, sk)) == vals
    assert bfv.noise_budget(ct, sk) > 0

    ct2 = bfv.encrypt(bfv.encode(ctx, pvals), sk, err_rng=det_rng(b"b"))
    assert bfv.decode(ctx, bfv.decrypt(bfv.ct_add(ct, ct2), sk)) == [(a + b) % t for a, b in zip(vals, pvals)]
    assert bfv.decode(ctx, bfv.decrypt(bfv.ct_sub(ct, ct2), sk)) == [(a - b) % t for a, b in zip(vals, pvals)]
    assert bfv.decode(ctx, bfv.decrypt(bfv.ct_neg(ct), sk)) == [(-a) % t for a in vals]

    pt2 = bfv.encode(ctx, pvals)
    assert bfv.decode(ctx, bfv.decrypt(bfv.ct_add_pt(ct, pt2), sk)) == [(a + b) % t for a, b in zip(vals, pvals)]
    assert bfv.decode(ctx, bfv.decrypt(bfv.ct_sub_pt(ct, pt2), sk)) == [(a - b) % t for a, b in zip(vals, pvals)]
    if ctx.supports_simd_encoding:
        sv = rand_values(ctx, seed=4)
        pv = rand_values(ctx, seed=5)
        sct = bfv.ct_to_eval(bfv.encrypt(bfv.encode(ctx, sv, fmt="simd"), sk, err_rng=det_rng(b"c")))
        spt = bfv.plaintext_to_eval(ctx, bfv.encode(ctx, pv, fmt="simd"))
        prod = bfv.ct_to_coeff(bfv.ct_mul_pt(sct, spt))
        assert bfv.decode(ctx, bfv.decrypt(prod, sk), fmt="simd") == [(a * b) % t for a, b in zip(sv, pv)]

    single = bfv.mod_switch_down_to_single(ct)
    assert len(single.polys[0].moduli) == 1
    assert bfv.decode(ctx, bfv.decrypt(single, sk)) == vals

    shifted = bfv.multiply_power_of_x(ct, 1)
    assert bfv.decode(ctx, bfv.decrypt(shifted, sk)) == [(-vals[-1]) % t] + vals[:-1]

    assert not bfv.is_transparent(ct)
    assert bfv.is_transparent(bfv.ct_sub(ct, ct))


def serialization_roundtrips(name, bits, device):
    """Seeded-ciphertext and skip-LSB (for decryption) wire round trips
    (she_tpu's test_serialization_roundtrips)."""
    ctx = make_ctx(name, bits, device)
    vals = rand_values(ctx, seed=6)
    sk = bfv.generate_secret_key(ctx, det_rng(b"s"))
    seed = bytes(range(32))
    ct = bfv.encrypt(bfv.encode(ctx, vals), sk, seed=seed, err_rng=det_rng(b"e"))

    s = ser.serialize_ciphertext(ct)
    assert s.kind == "seeded" and s.seed == seed
    back = ser.deserialize_ciphertext(s, ctx, "coeff")
    assert bfv.decode(ctx, bfv.decrypt(back, sk)) == vals

    single = bfv.mod_switch_down_to_single(ct)
    single = bfv.Ciphertext(ctx, single.polys, single.correction_factor)
    skip = ser.skip_lsbs_for_decryption(single)
    s2 = ser.serialize_ciphertext(single, for_decryption=True)
    assert s2.kind == "full"
    assert any(k > 0 for k in s2.skip_lsbs) or max(skip) == 0
    back2 = ser.deserialize_ciphertext(s2, ctx, "coeff", moduli_count=1)
    assert bfv.decode(ctx, bfv.decrypt(back2, sk)) == vals


def rotation_and_relinearization(name, bits, device):
    """Rotation and row swap through Galois keys, ct * ct with
    relinearization, at N >= 4096 (she_tpu's
    test_rotation_and_relinearization_at_production_n). Returns False
    where the set has one modulus and no key-switching context."""
    ctx = make_ctx(name, bits, device)
    if not ctx.supports_evaluation_key:
        return False
    t = ctx.plaintext_modulus
    sk = bfv.generate_secret_key(ctx, det_rng(b"s"))
    half = ctx.degree // 2

    if ctx.supports_simd_encoding:
        elements = (galoismod.rotating_columns_element(1, ctx.degree), galoismod.swapping_rows_element(ctx.degree))
        ek = keys.generate_evaluation_key(
            ctx, keys.EvaluationKeyConfig(galois_elements=elements, has_relinearization_key=True), sk, det_rng(b"k"))
        vals = rand_values(ctx, seed=7)
        ct = bfv.encrypt(bfv.encode(ctx, vals, fmt="simd"), sk, err_rng=det_rng(b"e"))
        rot = bfv.rotate_columns(ct, 1, ek)
        got = bfv.decode(ctx, bfv.decrypt(rot, sk), fmt="simd")
        rows = [vals[:half], vals[half:]]
        want = [r[-1:] + r[:-1] for r in rows]  # right rotation of each SIMD row
        assert got == want[0] + want[1]
        sw = bfv.swap_rows(ct, ek)
        assert bfv.decode(ctx, bfv.decrypt(sw, sk), fmt="simd") == vals[half:] + vals[:half]
    else:
        ek = keys.generate_evaluation_key(ctx, keys.EvaluationKeyConfig(has_relinearization_key=True), sk,
                                          det_rng(b"k"))

    rng = np.random.default_rng(8)
    a = [int(v) for v in rng.integers(0, min(t, 16), size=8)] + [0] * (ctx.degree - 8)
    b = [int(v) for v in rng.integers(0, min(t, 16), size=8)] + [0] * (ctx.degree - 8)
    ca = bfv.encrypt(bfv.encode(ctx, a), sk, err_rng=det_rng(b"1"))
    cb = bfv.encrypt(bfv.encode(ctx, b), sk, err_rng=det_rng(b"2"))
    prod = bfv.ct_mul_relin(ca, cb, ek)
    assert len(prod.polys) == 2
    got = bfv.decode(ctx, bfv.decrypt(prod, sk))
    full = np.convolve(np.array(a[:8], dtype=np.int64), np.array(b[:8], dtype=np.int64))
    want = [int(v) % t for v in full] + [0] * (ctx.degree - len(full))
    assert got == want[: ctx.degree]
    return True


def run_rotation(name, bits, device):
    if not rotation_and_relinearization(name, bits, device):
        pytest.skip("set has a single modulus: no key-switching context")


BITS = 32


def test_combo_lists_match_she_tpu():
    """The port's combo lists are she_tpu's, in order: 24 combos, 20 at
    production N."""
    import test_conformance_matrix as reference

    assert ALL_COMBOS == reference.ALL_COMBOS and len(ALL_COMBOS) == 24
    assert ROTATION_COMBOS == reference.ROTATION_COMBOS and len(ROTATION_COMBOS) == 20


@pytest.mark.parametrize("name,bits,route", cpu_cases(ALL_COMBOS, BITS), ids=case_ids(cpu_cases(ALL_COMBOS, BITS)))
def test_scheme_op_battery(monkeypatch, name, bits, route):
    set_route(monkeypatch, route)
    op_battery(name, bits, "cpu")


@pytest.mark.parametrize("name,bits,route", cpu_cases(ALL_COMBOS, BITS), ids=case_ids(cpu_cases(ALL_COMBOS, BITS)))
def test_serialization_roundtrips(monkeypatch, name, bits, route):
    set_route(monkeypatch, route)
    serialization_roundtrips(name, bits, "cpu")


@pytest.mark.parametrize("name,bits", combos(ROTATION_COMBOS, BITS), ids=case_ids(combos(ROTATION_COMBOS, BITS)))
def test_rotation_and_relinearization_at_production_n(monkeypatch, name, bits):
    set_route(monkeypatch, "kernel")
    run_rotation(name, bits, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name,bits,route", card_cases(ALL_COMBOS, BITS), ids=case_ids(card_cases(ALL_COMBOS, BITS)))
def test_scheme_op_battery_on_card(monkeypatch, name, bits, route):
    device = card()
    set_route(monkeypatch, route)
    op_battery(name, bits, device)


@pytest.mark.gpu
@pytest.mark.parametrize("name,bits,route", card_cases(ALL_COMBOS, BITS), ids=case_ids(card_cases(ALL_COMBOS, BITS)))
def test_serialization_roundtrips_on_card(monkeypatch, name, bits, route):
    device = card()
    set_route(monkeypatch, route)
    serialization_roundtrips(name, bits, device)


@pytest.mark.gpu
@pytest.mark.parametrize("name,bits,route", card_cases(ROTATION_COMBOS, BITS), ids=case_ids(card_cases(ROTATION_COMBOS, BITS)))
def test_rotation_and_relinearization_on_card(monkeypatch, name, bits, route):
    device = card()
    set_route(monkeypatch, route)
    run_rotation(name, bits, device)
