"""The CUDA NTT kernels against their plain PyTorch version, on the card.

Marked `gpu`: each test decides inside itself whether a card exists and
skips where there is none. This file imports only the port (no jax, no
she_tpu), so it also runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_kernels.py

Both kernel routes are covered: 32-bit words (every modulus below 2^30,
here the three largest NTT primes below 2^30) and 64-bit words (moduli in
[2^30, 2^31), which the plain version still takes, and the 55-bit moduli
of n_8192_logq_3x55_logt_24 against the big-int reference).
"""

import numpy as np
import pytest
import torch

from she_tpu_torch.ops import ntt as tntt
from she_tpu_torch.ops import ntt_cuda
from she_tpu_torch.utils import nt, refimpl

ROUTE_MODULI = {
    32: tuple(nt.generate_primes([30] * 3, preferring_small=False, ntt_degree=8192)),
    64: tuple(nt.generate_primes([31] * 3, preferring_small=True, ntt_degree=8192)),
}
W32_MODULI = ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727)
W64_MODULI = ((1 << 55) - 311295, (1 << 55) - 1392639, (1 << 55) - 1507327)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(moduli, degree, batch, seed=0, fill="random"):
    rng = np.random.default_rng(seed)
    rows = np.zeros((batch, len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        if fill == "random":
            rows[:, i, :] = rng.integers(0, q, size=(batch, degree))
        elif fill == "max":
            rows[:, i, :] = q - 1
    return torch.from_numpy(rows)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,nmod", [(1, 1), (1, 3), (5, 1)], ids=["1row", "3rows", "5rows"])
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
@pytest.mark.parametrize("degree", [2, 4, 8, 16, 32, 256, 4096, 8192])
@pytest.mark.parametrize("word_bits", [32, 64])
def test_kernel_matches_plain(word_bits, degree, fill, batch, nmod):
    dev = _card()
    moduli = ROUTE_MODULI[word_bits][:nmod]
    tables = tntt.build_ntt_tables(moduli, degree, dev)
    assert tables.word_bits == word_bits
    x = _rows(moduli, degree, batch, seed=degree, fill=fill).to(dev)
    before = dict(ntt_cuda.launches)
    fwd = ntt_cuda.forward(x, tables)
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, tables))
    inv = ntt_cuda.inverse(fwd, tables)
    assert torch.equal(inv, tntt.inverse_ntt_plain(fwd, tables))
    assert torch.equal(inv, x)
    assert ntt_cuda.launches["ntt_forward"] == before["ntt_forward"] + 1
    assert ntt_cuda.launches["ntt_inverse"] == before["ntt_inverse"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
def test_kernel_w64_moduli_round_trip_and_reference(fill):
    dev = _card()
    tables = tntt.build_ntt_tables(W64_MODULI, 8192, dev)
    assert tables.word_bits == 64
    x = _rows(W64_MODULI, 8192, batch=2, seed=3, fill=fill).to(dev)
    before = dict(ntt_cuda.launches)
    fwd = ntt_cuda.forward(x, tables)
    assert fwd[0, 2].tolist() == refimpl.forward_ntt(x[0, 2].tolist(), W64_MODULI[2])
    assert torch.equal(ntt_cuda.inverse(fwd, tables), x)
    assert ntt_cuda.launches["ntt_forward"] == before["ntt_forward"] + 1
    assert ntt_cuda.launches["ntt_inverse"] == before["ntt_inverse"] + 1


@pytest.mark.gpu
def test_dispatch_launches_kernel_for_cuda_tensors():
    dev = _card()
    tables = tntt.build_ntt_tables(W32_MODULI, 256, dev)
    x = _rows(W32_MODULI, 256, batch=1).to(dev)
    plain_before = dict(tntt.plain_calls_on_cuda)
    before = ntt_cuda.launches["ntt_forward"]
    tntt.forward_ntt(x, tables)
    assert ntt_cuda.launches["ntt_forward"] == before + 1
    assert tntt.plain_calls_on_cuda == plain_before
