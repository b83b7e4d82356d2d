"""The port's matrix NTT (ops/ntt_mxu.py) against she_tpu's
(she_tpu/ops/ntt_mxu.py) and against the port's butterfly NTT, bit for bit;
its dispatch under SHE_TPU_NTT_MXU against she_tpu's; and, on the card,
the phase kernel (csrc/ntt_mxu.cu) against its plain version.

The same seeded numpy residues go to both packages (she_tpu's uint32
limbs through she_tpu_torch/convert.py). The `gpu` cases decide inside
the test whether a card exists and skip where there is none:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_ntt_mxu.py

needs jax only for the CPU cases (imported inside them).
"""

import numpy as np
import pytest
import torch

from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.ops import ntt as tntt
from she_tpu_torch.ops import ntt_cuda, ntt_mxu, ntt_mxu_cuda
from she_tpu_torch.utils import nt

W32_MODULI = ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727)
W64_MODULI = ((1 << 55) - 311295, (1 << 55) - 1392639)
W60_MODULI = tuple(tparams.from_predefined("insecure_n_512_logq_4x60_logt_20").coefficient_moduli)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the plain matrix products gain little
    from more, and beside other test workers their thread teams thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# she_tpu's tests/test_ntt_mxu.py cases, and 4 x 60-bit moduli (9 digits)
CASES = [
    (W32_MODULI, 128, 1, ()),
    (W32_MODULI, 256, 1, (2, 3)),
    (W32_MODULI[:1], 4096, 1, (2,)),
    ((1073738753,), 128, 1, ()),
    (W64_MODULI, 256, 2, (2,)),
    (W64_MODULI, 8192, 2, ()),
    (W60_MODULI, 512, 2, (2,)),
]
IDS = ["w32_128", "w32_256_batch23", "w32_4096_one_modulus", "w30_128_D5", "w64_256", "w64_8192", "w60_512_D9"]


def _rows(moduli, degree, batch=(), seed=0, fill="random"):
    rng = np.random.default_rng(seed)
    rows = np.zeros(batch + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        if fill == "random":
            rows[..., i, :] = rng.integers(0, q, size=batch + (degree,))
        elif fill == "max":
            rows[..., i, :] = q - 1
    return rows


def _jax_word(rows, nlimbs):
    import jax.numpy as jnp

    from she_tpu.ops import word as wordmod

    return wordmod.as_word(jnp.asarray(convert.int64_to_limbs(rows, nlimbs)))


def _jax_values(word):
    return convert.limbs_to_int64(np.stack([np.asarray(w) for w in word]))


@pytest.mark.parametrize("moduli,degree,nlimbs,batch", CASES, ids=IDS)
def test_matches_she_tpu_and_butterfly(moduli, degree, nlimbs, batch):
    """The digit matrices equal she_tpu's; the port's plain matrix NTT
    equals she_tpu's ntt_mxu.forward_ntt / inverse_ntt and the port's
    butterfly forward_ntt_plain / inverse_ntt_plain, and round-trips."""
    from she_tpu.ops import ntt_mxu as jmxu

    t = ntt_mxu.build_mxu_tables(moduli, degree, CPU)
    jt = jmxu.build_mxu_tables(moduli, degree, nlimbs)
    assert (t.A, t.D) == (jt.A, jt.D)
    for name in ntt_mxu.MATRICES:
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(jt, name))
    bt = tntt.build_ntt_tables(moduli, degree, CPU)
    rows = _rows(moduli, degree, batch, seed=degree + len(batch))
    rows[(0,) * len(batch) + (slice(None), slice(0, 2))] = np.array(moduli)[:, None] - 1  # the largest residue
    x = torch.from_numpy(rows)
    fwd = ntt_mxu.forward_ntt(x, t)
    fwd_j = jmxu.forward_ntt(_jax_word(rows, nlimbs), jt)
    np.testing.assert_array_equal(fwd.numpy(), _jax_values(fwd_j))
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, bt))
    inv = ntt_mxu.inverse_ntt(fwd, t)
    np.testing.assert_array_equal(inv.numpy(), _jax_values(jmxu.inverse_ntt(fwd_j, jt)))
    assert torch.equal(inv, tntt.inverse_ntt_plain(fwd, bt))
    assert torch.equal(inv, x)


@pytest.mark.parametrize("flag", [None, "1", "0", "yes", ""])
@pytest.mark.parametrize("degree", [8, 64, 128, 4096])
def test_policy_matches_she_tpu(monkeypatch, flag, degree):
    """use_mxu answers as she_tpu's does for every setting of the variable."""
    from she_tpu.ops import ntt as jntt
    from she_tpu.ops import ntt_mxu as jmxu

    if flag is None:
        monkeypatch.delenv(ntt_mxu.ENV, raising=False)
    else:
        monkeypatch.setenv(ntt_mxu.ENV, flag)
    moduli = W32_MODULI[:1]
    want = jmxu.use_mxu(jntt.build_ntt_tables(moduli, degree, 1))
    assert ntt_mxu.use_mxu(tntt.build_ntt_tables(moduli, degree, CPU)) == want
    assert want == (flag == "1" and degree >= 128)


def test_dispatch_env(monkeypatch):
    """SHE_TPU_NTT_MXU=1 routes ops/ntt.py through the matrix NTT in both
    packages and the result stays bit-identical (she_tpu's
    test_dispatch_env); =0 routes it back."""
    from she_tpu.ops import ntt as jntt

    calls = []
    for name in ("forward_ntt", "inverse_ntt"):
        real = getattr(ntt_mxu, name)
        monkeypatch.setattr(ntt_mxu, name, lambda x, t, real=real, name=name: calls.append(name) or real(x, t))
    moduli, degree = W32_MODULI, 128
    tables = tntt.build_ntt_tables(moduli, degree, CPU)
    jt = jntt.build_ntt_tables(moduli, degree, 1)
    rows = _rows(moduli, degree, (2,), seed=7)
    x = torch.from_numpy(rows)
    plain = tntt.forward_ntt(x, tables)
    assert calls == []
    for flag, routed in (("1", ["forward_ntt", "inverse_ntt"]), ("0", [])):
        monkeypatch.setenv(ntt_mxu.ENV, flag)
        calls.clear()
        fwd = tntt.forward_ntt(x, tables)
        assert torch.equal(fwd, plain)
        np.testing.assert_array_equal(fwd.numpy(), _jax_values(jntt.forward_ntt(_jax_word(rows, 1), jt)))
        assert torch.equal(tntt.inverse_ntt(fwd, tables), x)
        assert calls == routed


@pytest.mark.parametrize("degree,want", [(64, False), (96, False), (128, True)])
def test_supports_degree_guard(degree, want):
    from she_tpu.ops import ntt_mxu as jmxu

    assert ntt_mxu.supports(W32_MODULI, degree) == jmxu.supports(W32_MODULI, degree) == want


@pytest.mark.parametrize("block", [0, 1])
def test_block_tables_never_take_the_matrix_route(monkeypatch, block):
    """A sharded NTT's per-rank block tables carry a sub-transform's
    twiddles: with the variable set they still take the butterfly NTT."""
    monkeypatch.setenv(ntt_mxu.ENV, "1")
    tables = tntt.build_block_tables(W32_MODULI, 512, 2, block, CPU)
    assert tables.degree == 256 and ntt_mxu.supports(tables.moduli, tables.degree)
    assert not ntt_mxu.use_mxu(tables)
    assert ntt_mxu.use_mxu(tntt.build_ntt_tables(W32_MODULI, 256, CPU))

    def refuse(x, t):
        raise AssertionError("block tables took the matrix NTT")

    monkeypatch.setattr(ntt_mxu, "forward_ntt", refuse)
    monkeypatch.setattr(ntt_mxu, "inverse_ntt", refuse)
    x = torch.from_numpy(_rows(W32_MODULI, 256, (2,), seed=3))
    fwd = tntt.forward_ntt(x, tables)
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, tables))
    assert torch.equal(tntt.inverse_ntt(fwd, tables), tntt.inverse_ntt_plain(fwd, tables))


def test_cpu_tensor_takes_plain_version():
    t = ntt_mxu.build_mxu_tables(W32_MODULI, 128, CPU)
    before = dict(ntt_mxu_cuda.launches), dict(ntt_cuda.launches)
    x = torch.from_numpy(_rows(W32_MODULI, 128, (2,)))
    assert torch.equal(ntt_mxu.inverse_ntt(ntt_mxu.forward_ntt(x, t), t), x)
    assert (dict(ntt_mxu_cuda.launches), dict(ntt_cuda.launches)) == before


@pytest.mark.parametrize(
    "case,error,match",
    [
        ("cpu", ValueError, "CUDA tensor"),
        ("non_contiguous", ValueError, "contiguous"),
        ("int32", TypeError, "int64"),
        ("shape", ValueError, "expects"),
    ],
)
def test_kernel_wrapper_refuses_what_it_does_not_take(case, error, match):
    t = ntt_mxu.build_mxu_tables(W32_MODULI, 128, CPU)
    x = torch.from_numpy(_rows(W32_MODULI, 128, (2,)))
    if case == "non_contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "int32":
        x = x.to(torch.int32)
    elif case == "shape":
        x = x[..., :64].contiguous()
    for matrix in ntt_mxu.MATRICES:
        with pytest.raises(error, match=match):
            ntt_mxu_cuda.ntt_mxu_phase(x, t, matrix)


def test_kernel_constants():
    """The epilogue's constants: q, floor(2^64 / q), 2^28 mod q and its
    Shoup constant, as unsigned bits in int64; and when the exact sum fits."""
    moduli = W60_MODULI[:2] + (65537,)
    c = ntt_mxu_cuda.constants(moduli, CPU).numpy().view(np.uint64)
    for l, q in enumerate(moduli):
        w = (1 << 28) % q
        assert [int(v) for v in c[:, l]] == [q, (1 << 64) // q, w, (w << 64) // q]
    assert ntt_mxu_cuda.exact64(W32_MODULI, 64) and not ntt_mxu_cuda.exact64(W32_MODULI, 1 << 9)
    assert not ntt_mxu_cuda.exact64(W64_MODULI, 2)


def test_tables_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="N >= 128"):
        ntt_mxu.build_mxu_tables(W32_MODULI, 64, CPU)
    q = next(q for q in range((1 << 62) + 1, (1 << 62) + (1 << 20), 256) if nt.is_prime(q))
    with pytest.raises(ValueError, match="below 2\\^62"):
        ntt_mxu.build_mxu_tables((q,), 128, CPU)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

KERNEL_BITS = {4: 28, 5: 33, 8: 55, 9: 60}  # bits of the moduli of each digit count


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_moduli(digits, degree):
    bits = KERNEL_BITS[digits]
    return tuple(nt.generate_primes([bits, bits - 1], preferring_small=False, ntt_degree=degree))


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
@pytest.mark.parametrize("matrix", ["Lf", "Rf", "Ri", "Li"])
@pytest.mark.parametrize("rows_a", [2, 4, 64, 128])
@pytest.mark.parametrize("digits", [4, 5, 8, 9])
def test_phase_kernel_matches_plain(digits, rows_a, matrix, fill):
    """ntt_mxu_phase against phase_plain: both phases of both directions,
    D in {4, 5, 8, 9}, A in {2, 4, 64, 128} (N = 128 .. 8192), batch 3 (70
    at A = 2: two column tiles of the block phase)."""
    dev = _card()
    degree = 64 * rows_a
    moduli = _kernel_moduli(digits, degree)
    t = ntt_mxu.build_mxu_tables(moduli, degree, dev)
    assert t.D == digits
    batch = (70,) if rows_a == 2 else (3,)
    x = torch.from_numpy(_rows(moduli, degree, batch, seed=digits + rows_a, fill=fill)).to(dev)
    got = ntt_mxu_cuda.ntt_mxu_phase(x, t, matrix)
    want = ntt_mxu.phase_plain(x, t, matrix)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("moduli,degree,nlimbs,batch", CASES, ids=IDS)
def test_matrix_ntt_matches_butterfly_kernel_on_card(moduli, degree, nlimbs, batch):
    """The whole matrix NTT on the card (two phase launches a direction)
    against the butterfly kernel, forward and inverse."""
    dev = _card()
    t = ntt_mxu.build_mxu_tables(moduli, degree, dev)
    bt = tntt.build_ntt_tables(moduli, degree, dev)
    x = torch.from_numpy(_rows(moduli, degree, batch, seed=5)).to(dev)
    before = ntt_mxu_cuda.launches["ntt_mxu_phase"]
    fwd = ntt_mxu.forward_ntt(x, t)
    assert torch.equal(fwd, ntt_cuda.forward(x, bt))
    inv = ntt_mxu.inverse_ntt(fwd, t)
    assert torch.equal(inv, ntt_cuda.inverse(fwd, bt))
    assert torch.equal(inv, x)
    assert ntt_mxu_cuda.launches["ntt_mxu_phase"] == before + 4


@pytest.mark.gpu
def test_dispatch_env_on_card(monkeypatch):
    """With the variable set, ops/ntt.py sends a CUDA tensor through the
    phase kernel and never through the butterfly kernel."""
    dev = _card()
    moduli, degree = W32_MODULI, 4096
    tables = tntt.build_ntt_tables(moduli, degree, dev)
    x = torch.from_numpy(_rows(moduli, degree, (4,), seed=9)).to(dev)
    want = ntt_cuda.forward(x, tables)
    monkeypatch.setenv(ntt_mxu.ENV, "1")
    before = dict(ntt_cuda.launches), ntt_mxu_cuda.launches["ntt_mxu_phase"]
    fwd = tntt.forward_ntt(x, tables)
    assert torch.equal(tntt.inverse_ntt(fwd, tables), x)
    assert torch.equal(fwd, want)
    assert dict(ntt_cuda.launches) == before[0]
    assert ntt_mxu_cuda.launches["ntt_mxu_phase"] == before[1] + 4
