"""The port's matrix NTT (ops/ntt_mxu.py) against she_tpu's
(she_tpu/ops/ntt_mxu.py) and against the port's butterfly NTT, bit for bit;
the factorization of the block matrices into one shared matrix and a
twist; its dispatch under SHE_TPU_NTT_MXU against she_tpu's; and, on the
card, the fused kernel (csrc/ntt_mxu.cu, one launch a direction) against
its plain version and the butterfly kernel.

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
from she_tpu_torch import trace
from she_tpu_torch.ops import modarith as ma
from she_tpu_torch.ops import ntt as tntt
from she_tpu_torch.ops import ntt_cuda, ntt_mxu, ntt_mxu_cuda
from she_tpu_torch.utils import nt

W32_MODULI = ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727)
W64_MODULI = ((1 << 55) - 311295, (1 << 55) - 1392639)
W60_MODULI = tuple(tparams.from_predefined("insecure_n_512_logq_4x60_logt_20").coefficient_moduli)
CPU = torch.device("cpu")
# the moduli of the w32 cell (27-28 bits), the w64 cell (3 x 55 bits) and
# the 60-bit conformance set
CELL_MODULI = {
    "w32_cell": tuple(tparams.from_predefined("n_4096_logq_27_28_28_logt_5", scalar_bits=32).coefficient_moduli),
    "w64_cell": tuple(tparams.from_predefined("n_8192_logq_3x55_logt_24").coefficient_moduli),
    "w60_conformance": W60_MODULI,
}


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
    """The digit matrices equal she_tpu's; the port's plain matrix NTT, in
    she_tpu's two phases and in the factored form the kernel computes,
    equals she_tpu's ntt_mxu.forward_ntt / inverse_ntt and the port's
    butterfly forward_ntt_plain / inverse_ntt_plain, and round-trips."""
    from she_tpu.ops import ntt_mxu as jmxu

    t = ntt_mxu.build_mxu_tables(moduli, degree, CPU)
    jt = jmxu.build_mxu_tables(moduli, degree, nlimbs)
    assert (t.A, t.D) == (jt.A, jt.D)
    for name in ntt_mxu.MATRICES:
        np.testing.assert_array_equal(ntt_mxu.phase_matrix(t, name).numpy(), getattr(jt, name))
    bt = tntt.build_ntt_tables(moduli, degree, CPU)
    rows = _rows(moduli, degree, batch, seed=degree + len(batch))
    rows[(0,) * len(batch) + (slice(None), slice(0, 2))] = np.array(moduli)[:, None] - 1  # the largest residue
    x = torch.from_numpy(rows)
    fwd = ntt_mxu.forward_factored_plain(x, t)
    fwd_j = jmxu.forward_ntt(_jax_word(rows, nlimbs), jt)
    np.testing.assert_array_equal(fwd.numpy(), _jax_values(fwd_j))
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, bt))
    assert torch.equal(fwd, ntt_mxu.forward_ntt_plain(x, t))
    assert torch.equal(ntt_mxu.forward_ntt(x, t), fwd)
    inv = ntt_mxu.inverse_factored_plain(fwd, t)
    np.testing.assert_array_equal(inv.numpy(), _jax_values(jmxu.inverse_ntt(fwd_j, jt)))
    assert torch.equal(inv, tntt.inverse_ntt_plain(fwd, bt))
    assert torch.equal(inv, ntt_mxu.inverse_ntt_plain(fwd, t))
    assert torch.equal(ntt_mxu.inverse_ntt(fwd, t), inv)
    assert torch.equal(inv, x)


def _values(planes: torch.Tensor) -> torch.Tensor:
    """int8 digit planes [L, D, ...] -> int64 values [L, ...]."""
    return sum(planes[:, i].to(torch.int64) << (7 * i) for i in range(planes.shape[1]))


@pytest.mark.parametrize("cell", list(CELL_MODULI))
@pytest.mark.parametrize("degree", [128, 256, 512])
def test_block_matrices_factor_into_shared_matrix_and_twist(cell, degree):
    """she_tpu's per-row block matrices are the port's one shared matrix
    times a twist, exactly mod q: Rf[l, a] = R_f[l] diag(s_f[l, a]) and
    Ri[l, a] = diag(s_i[l, a]) R_i[l], for every a, at 28-, 55- and 60-bit
    moduli; and the twists' Shoup constants are floor(s 2^64 / q)."""
    from she_tpu.ops import ntt_mxu as jmxu

    moduli = CELL_MODULI[cell]
    t = ntt_mxu.build_mxu_tables(moduli, degree, CPU)
    jt = jmxu.build_mxu_tables(moduli, degree, 2 if max(moduli) >= 1 << 32 else 1)
    Rf, Ri = _values(torch.from_numpy(jt.Rf)), _values(torch.from_numpy(jt.Ri))  # [L, A, 64, 64]
    R_f, R_i = _values(t.R_f), _values(t.R_i)  # [L, 64, 64]
    assert t.s_f.shape == t.s_i.shape == (len(moduli), degree // 64, 64)
    for l, q in enumerate(moduli):
        assert torch.equal(R_f[l], Rf[l, 0]) and torch.equal(R_i[l], Ri[l, 0])
        assert torch.equal(ma.mul_mod(R_f[l].expand_as(Rf[l]), t.s_f[l][:, None, :], q), Rf[l])
        assert torch.equal(ma.mul_mod(R_i[l].expand_as(Ri[l]), t.s_i[l][:, :, None], q), Ri[l])
        assert int(t.s_f[l].max()) < q and int(t.s_i[l].min()) > 0
        for s, shoup in ((t.s_f[l], t.s_f_shoup[l]), (t.s_i[l], t.s_i_shoup[l])):
            got = [v & ((1 << 64) - 1) for v in shoup.reshape(-1).tolist()]
            assert got == [(int(v) << 64) // q for v in s.reshape(-1).tolist()]


def test_factorization_refuses_other_matrices():
    """A block matrix that is not the shared one times a twist raises."""
    q = W32_MODULI[0]
    t = ntt_mxu.build_mxu_tables((q,), 128, CPU)
    blocks = torch.stack([_values(t.R_f)[0]] * 2).clone()
    ntt_mxu.factor_block_matrices(blocks, q, forward=True)
    blocks[1, 3, 5] = (blocks[1, 3, 5] + 1) % q
    with pytest.raises(AssertionError, match="shared matrix times a twist"):
        ntt_mxu.factor_block_matrices(blocks, q, forward=True)


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
    before = trace.launch_total
    x = torch.from_numpy(_rows(W32_MODULI, 128, (2,)))
    assert torch.equal(ntt_mxu.inverse_ntt(ntt_mxu.forward_ntt(x, t), t), x)
    assert trace.launch_total == before


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
    for direction in (ntt_mxu_cuda.ntt_mxu_forward, ntt_mxu_cuda.ntt_mxu_inverse):
        with pytest.raises(error, match=match):
            direction(x, t)


def test_kernel_constants():
    """The fold's constants: q, floor(2^64 / q), 2^42 mod q and its Shoup
    constant, as unsigned bits in int64, and 1 / q in float64; when the
    intermediate may stay in [0, 2q); the twist tables at 28 bits (s and
    its 32-bit Shoup constant in one word) and at 55 (both 64-bit)."""
    moduli = W60_MODULI[:2] + (65537,)
    c = ntt_mxu_cuda.constants(moduli, CPU).numpy().view(np.uint64)
    for l, q in enumerate(moduli):
        w = (1 << 42) % q
        assert [int(v) for v in c[:4, l]] == [q, (1 << 64) // q, w, (w << 64) // q]
    np.testing.assert_array_equal(c[4].view(np.float64), [1.0 / q for q in moduli])
    for moduli in (W32_MODULI, W64_MODULI):
        t = ntt_mxu.build_mxu_tables(moduli, 128, CPU)
        table = ntt_mxu_cuda.twist_table(t.s_f, t.s_f_shoup, moduli, t.D).numpy().view(np.uint64)
        for l, q in enumerate(moduli):
            s = [int(v) for v in t.s_f[l].reshape(-1)]
            if t.D <= 4:
                assert [int(v) for v in table[l].reshape(-1)] == [v | ((v << 32) // q) << 32 for v in s]
            else:
                assert [int(v) for v in table[l, ..., 0].reshape(-1)] == s
                assert [int(v) for v in table[l, ..., 1].reshape(-1)] == [(v << 64) // q for v in s]
    assert ntt_mxu_cuda.lazy(W64_MODULI, 8) and ntt_mxu_cuda.lazy(W60_MODULI, 9)
    assert not ntt_mxu_cuda.lazy(W32_MODULI, 4) and ntt_mxu_cuda.lazy(W32_MODULI[:1], 4)


@pytest.mark.parametrize("digits", range(1, 10))
def test_kernel_fold_bounds(digits):
    """The kernel's exact fold (D <= 4) and chunked fold (D > 4) stay within
    64 bits over its whole domain: at D <= 4 every exact dot product of K
    <= 128 matrix entries below q < 2^(7D) and values below 2^(7D) fits 64
    bits; above, no such sum fits for K = 64 and the smallest q of D digits,
    each digit weight's sum stays below 2^24.2, a pair below 2^32, a chunk
    of three pairs below 2^60 and r 2^42 + chunk after a Shoup step, below
    2q + 2^60, stays below 2^64 for q < 2^62."""
    top = (1 << 7 * digits) - 1
    q_max = min(top, (1 << 62) - 1)
    if digits <= 4:
        assert 128 * (q_max - 1) * top < 1 << 64
    else:
        q_min = 1 << 7 * (digits - 1)
        assert 64 * (q_min - 1) * top >= 1 << 64
    weight = 128 * 127 * 127 * digits
    pair = weight + (weight << 7)
    assert weight < 1 << 25 and pair < 1 << 32
    chunk = sum(pair << 14 * i for i in range(3))
    assert chunk < 1 << 60 and 2 * q_max + chunk < 1 << 64


@pytest.mark.parametrize("rows,kbytes", [(64, 32), (64, 64), (128, 128)])
def test_operand_image_layout(rows, kbytes):
    """operand_image puts element (r, k) of every plane at the documented
    offset of wgmma's K-major layout without swizzling, zero past the
    planes' rows and K."""
    rng = np.random.default_rng(rows + kbytes)
    R, K = min(rows, 40), min(kbytes, 24)
    planes = torch.from_numpy(rng.integers(1, 128, size=(2, 3, R, K)).astype(np.int8))
    image = ntt_mxu_cuda.operand_image(planes, rows, kbytes)
    assert image.shape == (2, 3, rows * kbytes)
    want = np.zeros((2, 3, rows * kbytes), dtype=np.int8)
    for r in range(R):
        for k in range(K):
            want[:, :, (r // 8) * 8 * kbytes + (k // 16) * 128 + (r % 8) * 16 + k % 16] = planes[:, :, r, k].numpy()
    np.testing.assert_array_equal(image.numpy(), want)


@pytest.mark.parametrize("moduli,degree", [(W32_MODULI, 128), (W64_MODULI, 8192)], ids=["w32_128", "w64_8192"])
def test_tables_hold_the_kernel_operands(moduli, degree):
    """The tables carry the kernel's operands, made once with them: each
    direction's row and block matrix images and twist table, and the
    constants; the per-row block matrices are not kept."""
    t = ntt_mxu.build_mxu_tables(moduli, degree, CPU)
    rows, kbytes = max(t.A, 64), max(t.A, 32)
    assert not hasattr(t, "Rf") and not hasattr(t, "Ri")
    assert torch.equal(t.operands["constants"], ntt_mxu_cuda.constants(moduli, CPU))
    for direction, row, block, twist, shoup in (("forward", t.Lf, t.R_f, t.s_f, t.s_f_shoup),
                                                ("inverse", t.Li, t.R_i, t.s_i, t.s_i_shoup)):
        got = t.operands[direction]
        assert torch.equal(got[0], ntt_mxu_cuda.operand_image(row, rows, kbytes))
        assert torch.equal(got[1], ntt_mxu_cuda.operand_image(block, 64, 64))
        assert torch.equal(got[2], ntt_mxu_cuda.twist_table(twist, shoup, moduli, t.D))


def test_tables_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="N >= 128"):
        ntt_mxu.build_mxu_tables(W32_MODULI, 64, CPU)
    q = next(q for q in range((1 << 62) + 1, (1 << 62) + (1 << 20), 256) if nt.is_prime(q))
    with pytest.raises(ValueError, match="below 2\\^62"):
        ntt_mxu.build_mxu_tables((q,), 128, CPU)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

KERNEL_BITS = {4: 28, 5: 35, 6: 42, 8: 55, 9: 60}  # bits of the moduli of each digit count


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_moduli(digits, degree):
    bits = KERNEL_BITS[digits]
    return tuple(nt.generate_primes([bits, bits - 1], preferring_small=False, ntt_degree=degree))


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("rows_a", [2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("digits", [4, 5, 6, 8, 9])
def test_fused_kernel_matches_plain(digits, rows_a, direction, fill):
    """The fused kernel, one launch a direction, against the factored plain
    version and the butterfly kernel: D in {4, 5, 6, 8, 9} (5 and 6 end
    with a partial chunk of digit weights), A in {2, ..., 128} (N = 128 ..
    8192), fills 0, q - 1 and random, a batch of 5 (two units a block at
    A <= 64, one at A = 128: not a multiple of either)."""
    dev = _card()
    degree = 64 * rows_a
    moduli = _kernel_moduli(digits, degree)
    t = ntt_mxu.build_mxu_tables(moduli, degree, dev)
    bt = tntt.build_ntt_tables(moduli, degree, dev)
    assert t.D == digits
    x = torch.from_numpy(_rows(moduli, degree, (5,), seed=digits + rows_a, fill=fill)).to(dev)
    before = trace.counters["launch.ntt_mxu"]
    if direction == "forward":
        got, want, butterfly = (ntt_mxu_cuda.ntt_mxu_forward(x, t), ntt_mxu.forward_factored_plain(x, t),
                                ntt_cuda.forward(x, bt))
    else:
        got, want, butterfly = (ntt_mxu_cuda.ntt_mxu_inverse(x, t), ntt_mxu.inverse_factored_plain(x, t),
                                ntt_cuda.inverse(x, bt))
    torch.cuda.synchronize()
    assert trace.counters["launch.ntt_mxu"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, butterfly)


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("rows_a", [2, 64, 128])
@pytest.mark.parametrize("digits", [4, 8, 9])
def test_fused_kernel_serves_many_units_a_slot(digits, rows_a, direction):
    """A batch over three times the persistent grid's unit slots (one
    modulus: a block an SM, two units in flight a block at A <= 64, one at
    A = 128), so every slot serves at least three units in turn: the
    staging barrier's phase flips, the next unit's staging or L2 prefetch
    and the shared buffers reused across units (at D = 9, A = 128 the
    matrices copied in again before each product), against the factored
    plain version and the butterfly kernel."""
    dev = _card()
    slots = torch.cuda.get_device_properties(dev).multi_processor_count * (2 if rows_a <= 64 else 1)
    degree = 64 * rows_a
    moduli = _kernel_moduli(digits, degree)[:1]
    t = ntt_mxu.build_mxu_tables(moduli, degree, dev)
    bt = tntt.build_ntt_tables(moduli, degree, dev)
    rows = _rows(moduli, degree, (3 * slots + 5,), seed=digits + rows_a)
    rows[-1, :, :3] = np.array(moduli)[:, None] - 1
    x = torch.from_numpy(rows).to(dev)
    before = trace.counters["launch.ntt_mxu"]
    if direction == "forward":
        got, want, butterfly = (ntt_mxu_cuda.ntt_mxu_forward(x, t), ntt_mxu.forward_factored_plain(x, t),
                                ntt_cuda.forward(x, bt))
    else:
        got, want, butterfly = (ntt_mxu_cuda.ntt_mxu_inverse(x, t), ntt_mxu.inverse_factored_plain(x, t),
                                ntt_cuda.inverse(x, bt))
    torch.cuda.synchronize()
    assert trace.counters["launch.ntt_mxu"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, butterfly)


@pytest.mark.gpu
@pytest.mark.parametrize("moduli,degree,nlimbs,batch", CASES, ids=IDS)
def test_matrix_ntt_matches_butterfly_kernel_on_card(moduli, degree, nlimbs, batch):
    """The whole matrix NTT on the card (one launch a direction) against
    the butterfly kernel, forward and inverse."""
    dev = _card()
    t = ntt_mxu.build_mxu_tables(moduli, degree, dev)
    bt = tntt.build_ntt_tables(moduli, degree, dev)
    x = torch.from_numpy(_rows(moduli, degree, batch, seed=5)).to(dev)
    before = trace.counters["launch.ntt_mxu"]
    fwd = ntt_mxu.forward_ntt(x, t)
    assert torch.equal(fwd, ntt_cuda.forward(x, bt))
    inv = ntt_mxu.inverse_ntt(fwd, t)
    assert torch.equal(inv, ntt_cuda.inverse(fwd, bt))
    assert torch.equal(inv, x)
    assert trace.counters["launch.ntt_mxu"] == before + 2


@pytest.mark.gpu
def test_dispatch_env_on_card(monkeypatch):
    """With the variable set, ops/ntt.py sends a CUDA tensor through the
    fused kernel and never through the butterfly kernel."""
    dev = _card()
    moduli, degree = W32_MODULI, 4096
    tables = tntt.build_ntt_tables(moduli, degree, dev)
    x = torch.from_numpy(_rows(moduli, degree, (4,), seed=9)).to(dev)
    want = ntt_cuda.forward(x, tables)
    monkeypatch.setenv(ntt_mxu.ENV, "1")
    before = [trace.counters["launch." + k] for k in ("ntt_forward", "ntt_inverse", "ntt_mxu")]
    fwd = tntt.forward_ntt(x, tables)
    assert torch.equal(tntt.inverse_ntt(fwd, tables), x)
    assert torch.equal(fwd, want)
    assert [trace.counters["launch." + k] for k in ("ntt_forward", "ntt_inverse", "ntt_mxu")] == [
        before[0], before[1], before[2] + 2]


@pytest.mark.gpu
def test_misaligned_input_on_card():
    """A contiguous view that does not start on 16 bytes goes through the
    kernel all the same."""
    dev = _card()
    moduli, degree = W32_MODULI, 128
    t = ntt_mxu.build_mxu_tables(moduli, degree, dev)
    x = torch.from_numpy(_rows(moduli, degree, (3,), seed=4)).to(dev)
    flat = torch.cat((x.new_zeros(1), x.reshape(-1)))[1:].view(x.shape)
    assert flat.data_ptr() % 16 and flat.is_contiguous()
    assert torch.equal(ntt_mxu_cuda.ntt_mxu_forward(flat, t), ntt_mxu.forward_factored_plain(x, t))
