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
from she_tpu_torch.ops import ntt as tntt
from she_tpu_torch.ops import ntt_cuda

W32_MODULI = ((1 << 28) - 65535, (1 << 28) - 73727)
CPU = torch.device("cpu")


def _rows(moduli, degree, batch, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.zeros((batch, len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        rows[:, i, :] = rng.integers(0, q, size=(batch, degree))
    return rows


def _jax_word(rows):
    return wordmod.as_word(wordmod.pack(rows.astype(object), 1))


def _jax_values(word):
    return np.asarray(word[0]).astype(np.int64)


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
    before = dict(ntt_cuda.launches)
    x = torch.from_numpy(_rows(W32_MODULI, 8, batch=2))
    tntt.inverse_ntt(tntt.forward_ntt(x, tables), tables)
    assert ntt_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensor():
    tables = tntt.build_ntt_tables(W32_MODULI, 8, CPU)
    x = torch.from_numpy(_rows(W32_MODULI, 8, batch=1))
    with pytest.raises(ValueError):
        ntt_cuda.forward(x, tables)
    with pytest.raises(ValueError):
        ntt_cuda.inverse(x, tables)


def test_plain_refuses_wide_moduli():
    tables = tntt.build_ntt_tables(((1 << 55) - 311295,), 8, CPU)
    with pytest.raises(ValueError):
        tntt.forward_ntt(torch.zeros((1, 8), dtype=torch.int64), tables)
