"""The port's NTT (tables and plain PyTorch version) against
she_tpu's staged XLA NTT and its Pallas kernel, bit for bit.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from she_tpu.ops import ntt as jntt
from she_tpu.ops import ntt_pallas
from she_tpu.ops import word as wordmod
from she_tpu.utils import refimpl
from she_tpu_torch import trace
from she_tpu_torch.ops import ntt as tntt
from she_tpu_torch.ops import ntt_cuda

W32_MODULI = ((1 << 28) - 65535, (1 << 28) - 73727)
W64_MODULI = (36028797018652673, 288230376151748609, 1152921504606830593)  # 55, 59, 60 bits
CPU = torch.device("cpu")


def _rows(moduli, degree, batch, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.zeros((batch, len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        rows[:, i, :] = rng.integers(0, q, size=(batch, degree))
    return rows


def _u32(tensor):
    return tensor.numpy().view(np.uint32)


def _jax_word(rows, nlimbs=1):
    return wordmod.as_word(wordmod.pack(rows.astype(object), nlimbs))


def _jax_values(word):
    return wordmod.unpack(np.stack([np.asarray(w) for w in word])).astype(np.int64)


@pytest.mark.parametrize("degree", [8, 256, 512])
def test_tables_match_she_tpu(degree):
    tables = tntt.build_ntt_tables(W32_MODULI, degree, CPU)
    j32 = jntt.build_ntt_tables(W32_MODULI, degree, 1)
    for name in ("roots", "inv_roots", "n_inv", "n_inv_w", "q"):
        np.testing.assert_array_equal(
            getattr(tables, name).numpy(), wordmod.unpack(getattr(j32, name)).astype(np.int64)
        )
    # she_tpu's two-limb tables carry the same 64-bit Shoup constants
    j64 = jntt.build_ntt_tables(W32_MODULI, degree, 2)
    for name in ("roots_shoup", "inv_roots_shoup", "n_inv_shoup", "n_inv_w_shoup"):
        got = getattr(tables, name).numpy().view(np.uint64).astype(object)
        np.testing.assert_array_equal(got, wordmod.unpack(getattr(j64, name)))


@pytest.mark.parametrize("degree", [8, 256, 512])
def test_w32_tables_match_she_tpu(degree):
    """The kernel's 32-bit route reads she_tpu's one-limb tables, Shoup
    constants floor(w * 2^32 / q) included, bit for bit."""
    tables = tntt.build_ntt_tables(W32_MODULI, degree, CPU)
    assert tables.word_bits == 32
    j32 = jntt.build_ntt_tables(W32_MODULI, degree, 1)
    for name in ("roots", "roots_shoup", "inv_roots", "inv_roots_shoup", "n_inv",
                 "n_inv_shoup", "n_inv_w", "n_inv_w_shoup", "q"):
        got = getattr(tables.w32, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_u32(got), getattr(j32, name)[0])


@pytest.mark.parametrize(
    "q",
    [(1 << 30) - 1, 1 << 30, (1 << 30) + 1, 1073692673, 1073872897, (1 << 28) - 65535,
     (1 << 55) - 311295],
)
def test_word_bits_follow_she_tpu_limbs(q):
    assert tntt.ntt_word_bits((q,)) == 32 * wordmod.nlimbs_for_modulus(q)
    # one wide modulus sends the whole launch to 64-bit words
    assert tntt.ntt_word_bits(((1 << 28) - 65535, q)) == 32 * wordmod.nlimbs_for_modulus(q)


def test_w64_tables_have_no_w32_route():
    tables = tntt.build_ntt_tables((1073872897,), 8, CPU)
    assert tables.word_bits == 64 and tables.w32 is None


@pytest.mark.parametrize("degree", [8, 256, 512])
def test_plain_matches_staged(degree):
    tables = tntt.build_ntt_tables(W32_MODULI, degree, CPU)
    jt = jntt.build_ntt_tables(W32_MODULI, degree, 1)
    rows = _rows(W32_MODULI, degree, batch=3, seed=degree)
    fwd = tntt.forward_ntt(torch.from_numpy(rows), tables)
    fwd_j = jntt.forward_ntt(_jax_word(rows), jt)
    np.testing.assert_array_equal(fwd.numpy(), _jax_values(fwd_j))
    expect = refimpl.forward_ntt([int(v) for v in rows[0, 1]], W32_MODULI[1])
    assert fwd[0, 1].tolist() == expect
    inv = tntt.inverse_ntt(fwd, tables)
    np.testing.assert_array_equal(inv.numpy(), _jax_values(jntt.inverse_ntt(fwd_j, jt)))
    np.testing.assert_array_equal(inv.numpy(), rows)


@pytest.mark.parametrize("degree", [256, 512])
def test_plain_matches_pallas_interpret(monkeypatch, degree):
    monkeypatch.setenv("SHE_TPU_NTT_PALLAS", "1")
    jt = jntt.build_ntt_tables(W32_MODULI, degree, 1)
    assert ntt_pallas.use_pallas(jt)
    tables = tntt.build_ntt_tables(W32_MODULI, degree, CPU)
    rows = _rows(W32_MODULI, degree, batch=3, seed=7)
    fwd_p = ntt_pallas.forward_ntt(_jax_word(rows), jt)
    fwd = tntt.forward_ntt(torch.from_numpy(rows), tables)
    np.testing.assert_array_equal(fwd.numpy(), _jax_values(fwd_p))
    inv_p = ntt_pallas.inverse_ntt(fwd_p, jt)
    np.testing.assert_array_equal(tntt.inverse_ntt(fwd, tables).numpy(), _jax_values(inv_p))


def test_cpu_tensor_takes_plain_version():
    tables = tntt.build_ntt_tables(W32_MODULI, 8, CPU)
    before = trace.launch_total
    x = torch.from_numpy(_rows(W32_MODULI, 8, batch=2))
    tntt.inverse_ntt(tntt.forward_ntt(x, tables), tables)
    assert trace.launch_total == before


def test_kernel_wrapper_refuses_cpu_tensor():
    tables = tntt.build_ntt_tables(W32_MODULI, 8, CPU)
    x = torch.from_numpy(_rows(W32_MODULI, 8, batch=1))
    with pytest.raises(ValueError):
        ntt_cuda.forward(x, tables)
    with pytest.raises(ValueError):
        ntt_cuda.inverse(x, tables)


@pytest.mark.parametrize(
    "case,error,match",
    [
        ("cpu", ValueError, "CUDA tensor"),
        ("non_contiguous", ValueError, "contiguous"),
        ("int32", TypeError, "int64"),
    ],
)
def test_kernel_wrapper_refuses_what_it_does_not_take(case, error, match):
    tables = tntt.build_ntt_tables(W32_MODULI, 8, CPU)
    x = torch.from_numpy(_rows(W32_MODULI, 8, batch=2))
    if case == "non_contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "int32":
        x = x.to(torch.int32)
    for wrapper in (ntt_cuda.forward, ntt_cuda.inverse):
        with pytest.raises(error, match=match):
            wrapper(x, tables)


def test_plain_refuses_wide_moduli():
    """Moduli up to the kernel's 2^62 are taken (below); a wider one has
    no exact plain transform and raises."""
    q = next(q for q in range((1 << 62) + 17, (1 << 62) + (1 << 20), 16) if tntt.nt.is_prime(q))
    tables = tntt.build_ntt_tables((q,), 8, CPU)
    with pytest.raises(ValueError, match="below 2\\^62"):
        tntt.forward_ntt(torch.zeros((1, 8), dtype=torch.int64), tables)


def test_plain_ntt_limit_is_the_kernels():
    assert tntt.PLAIN_MAX_MODULUS == ntt_cuda.MAX_MODULUS == 1 << 62


@pytest.mark.parametrize("degree", [8, 256, 512])
def test_plain_takes_wide_moduli(degree):
    """55/59/60-bit moduli: the plain NTT (wide route) against she_tpu's
    staged NTT with two-limb tables and the big-int reference."""
    tables = tntt.build_ntt_tables(W64_MODULI, degree, CPU)
    assert tables.word_bits == 64
    jt = jntt.build_ntt_tables(W64_MODULI, degree, 2)
    rows = _rows(W64_MODULI, degree, batch=3, seed=degree + 1)
    rows[0, :, :2] = np.array(W64_MODULI)[:, None] - 1  # the largest residue
    fwd = tntt.forward_ntt(torch.from_numpy(rows), tables)
    fwd_j = jntt.forward_ntt(_jax_word(rows, 2), jt)
    np.testing.assert_array_equal(fwd.numpy(), _jax_values(fwd_j))
    assert fwd[1, 2].tolist() == refimpl.forward_ntt([int(v) for v in rows[1, 2]], W64_MODULI[2])
    inv = tntt.inverse_ntt(fwd, tables)
    np.testing.assert_array_equal(inv.numpy(), _jax_values(jntt.inverse_ntt(fwd_j, jt)))
    np.testing.assert_array_equal(inv.numpy(), rows)


@pytest.mark.parametrize("degree", [256, 512])
def test_plain_wide_matches_pallas_interpret(monkeypatch, degree):
    monkeypatch.setenv("SHE_TPU_NTT_PALLAS", "1")
    jt = jntt.build_ntt_tables(W64_MODULI, degree, 2)
    assert ntt_pallas.use_pallas(jt)
    tables = tntt.build_ntt_tables(W64_MODULI, degree, CPU)
    rows = _rows(W64_MODULI, degree, batch=2, seed=11)
    fwd_p = ntt_pallas.forward_ntt(_jax_word(rows, 2), jt)
    fwd = tntt.forward_ntt(torch.from_numpy(rows), tables)
    np.testing.assert_array_equal(fwd.numpy(), _jax_values(fwd_p))
    inv_p = ntt_pallas.inverse_ntt(fwd_p, jt)
    np.testing.assert_array_equal(tntt.inverse_ntt(fwd, tables).numpy(), _jax_values(inv_p))
