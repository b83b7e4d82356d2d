"""The port's sharded polynomials (she_tpu_torch.parallel.sharded) against
she_tpu, bit for bit, with gloo ranks on the CPU.

The counterpart of tests/test_sharded.py: the N-sharded NTT (the first
log2 S stages exchanged between ranks, the rest in the port's NTT with the
block's derived tables), the limb-parallel NTT and the N-sharded BEHZ ct x
ct multiply. One world of 2 ranks and one of 4, each spawned once in a
module fixture (parallel.mesh.run_ranks, tests/torch_mesh_ranks.py);
every rank returns every case's whole output, which must equal she_tpu's
single-device forward_ntt / inverse_ntt / bfv.ct_mul on the same
numpy-seeded inputs. Tolerance 0: exact equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.ops import ntt as jntt
from she_tpu.ops import word as jword
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert, errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.ops import ntt
from she_tpu_torch.parallel import mesh as meshmod
from she_tpu_torch.parallel import sharded
from she_tpu_torch.utils import nt

W32 = ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727)
W64 = ((1 << 55) - 311295, (1 << 55) - 1392639, (1 << 55) - 1507327)
W32_L4 = tuple(nt.generate_primes([28] * 4, preferring_small=True, ntt_degree=4096))
WORLDS = (2, 4)
# name -> (moduli, N, S): 4096 and 256 as in she_tpu's test, 64 and 8 with
# all stages but the last exchanged between ranks at N = 2S
NTT_CASES = {
    f"{label}-N{n}-S{S}": (moduli, n, S)
    for label, moduli, n in (("w32", W32, 4096), ("w64", W64, 256), ("w32", W32, 64))
    for S in WORLDS
} | {"w32-N8-S4": (W32[:1], 8, 4), "w32-N4-S2": (W32[:1], 4, 2)}
LIMB_CASES = {"w32-L4-S2": (W32_L4, 4096, 2), "w32-L4-S4": (W32_L4, 4096, 4), "w64-L2-S2": (W64[:2], 256, 2)}
CT_MUL_CASES = {"n_4096_logq_27_28_28_logt_5-w32-S2": ("n_4096_logq_27_28_28_logt_5", 32, 2),
                "insecure_n_8_logq_5x18_logt_5-w64-S4": ("insecure_n_8_logq_5x18_logt_5", 64, 4)}


def _seed(tag):
    return (tag * 32)[:32]


def _residues(moduli, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=n) for q in moduli])


@functools.lru_cache(maxsize=None)
def _she_tpu_ntt(moduli, n):
    """Residues seeded by the shape, she_tpu's forward of them and its
    inverse of them, as int64 [L, N]."""
    x = _residues(moduli, n, n + len(moduli))
    nlimbs = 1 if ntt.ntt_word_bits(moduli) == 32 else 2
    tables = jntt.build_ntt_tables(moduli, n, nlimbs)
    words = jnp.asarray(convert.int64_to_limbs(x, nlimbs))
    # one program a direction: she_tpu's stages compile op by op otherwise
    fwd = np.asarray(jax.jit(lambda w: jnp.stack(jntt.forward_ntt(jword.as_word(w), tables)))(words))
    inv = np.asarray(jax.jit(lambda w: jnp.stack(jntt.inverse_ntt(jword.as_word(w), tables)))(words))
    return x, convert.limbs_to_int64(fwd), convert.limbs_to_int64(inv)


def _ct_mul(params, bits):
    """Two ciphertexts of random values and she_tpu's bfv.ct_mul of them."""
    ctx = jbfv.get_bfv_context(jparams.from_predefined(params, bits))
    sk = jbfv.generate_secret_key(ctx, jrng(_seed(b"s")))
    t = ctx.plaintext_modulus
    rng = np.random.default_rng(7)
    va, vb = ([int(v) for v in rng.integers(0, t, size=ctx.degree)] for _ in range(2))
    cts = [jbfv.encrypt(jbfv.encode(ctx, v), sk, seed=_seed(tag), err_rng=jrng(_seed(tag + b"e")))
           for v, tag in ((va, b"a"), (vb, b"b"))]
    want = np.stack([convert.limbs_to_int64(np.asarray(p.data)) for p in jbfv.ct_mul(*cts).polys])
    limbs, sk_limbs = [[np.asarray(p.data) for p in ct.polys] for ct in cts], np.asarray(sk.poly.data)
    full = np.convolve(np.array(va, dtype=object), np.array(vb, dtype=object))
    n = ctx.degree
    folded = full[:n].copy()
    folded[: len(full) - n] -= full[n:]
    return dict(cts=limbs, want=want, sk=sk_limbs, product=[int(v) % t for v in folded])


@pytest.fixture(scope="module")
def cases():
    spec = {"ntt": {}, "limb": {}, "ct_mul": {}}
    want = {}
    for name, (moduli, n, S) in NTT_CASES.items():
        x, fwd, inv = _she_tpu_ntt(moduli, n)
        spec["ntt"][name] = dict(moduli=moduli, degree=n, S=S, x=x)
        want[f"ntt/{name}"] = (fwd, inv)
    for name, (moduli, n, S) in LIMB_CASES.items():
        x, fwd, _ = _she_tpu_ntt(moduli, n)
        spec["limb"][name] = dict(moduli=moduli, degree=n, S=S, x=x)
        want[f"limb/{name}"] = fwd
    for name, (params, bits, S) in CT_MUL_CASES.items():
        c = _ct_mul(params, bits)
        spec["ct_mul"][name] = dict(params=params, bits=bits, S=S, cts=c["cts"])
        want[f"ct_mul/{name}"] = c
    return spec, want


@pytest.fixture(scope="module")
def ranks(cases):
    spec, _ = cases
    return {S: meshmod.run_ranks(torch_mesh_ranks.sharded_ranks, (S,), ("n",), "gloo", "cpu", spec) for S in WORLDS}


@pytest.mark.parametrize("name", list(NTT_CASES))
def test_sharded_ntt(ranks, cases, name):
    """Forward and inverse, each rank ending with the whole transform;
    the inverse of the forward gives the input back."""
    x = cases[0]["ntt"][name]["x"]
    fwd, inv = cases[1][f"ntt/{name}"]
    for out in ranks[NTT_CASES[name][2]]:
        got = out[f"ntt/{name}"]
        np.testing.assert_array_equal(got["forward"], fwd)
        np.testing.assert_array_equal(got["inverse_of_x"], inv)
        np.testing.assert_array_equal(got["inverse"], x)


@pytest.mark.parametrize("name", list(LIMB_CASES))
def test_limb_parallel_ntt(ranks, cases, name):
    x = cases[0]["limb"][name]["x"]
    for out in ranks[LIMB_CASES[name][2]]:
        got = out[f"limb/{name}"]
        np.testing.assert_array_equal(got["forward"], cases[1][f"limb/{name}"])
        np.testing.assert_array_equal(got["inverse"], x)


@pytest.mark.parametrize("name", list(CT_MUL_CASES))
def test_sharded_ct_mul(ranks, cases, name):
    """Bit-equal to bfv.ct_mul, and decrypts to the negacyclic product."""
    params, bits, S = CT_MUL_CASES[name]
    want = cases[1][f"ct_mul/{name}"]
    for out in ranks[S]:
        np.testing.assert_array_equal(out[f"ct_mul/{name}"], want["want"])
    ctx = tbfv.get_bfv_context(tparams.from_predefined(params, bits), device="cpu")
    sk = convert.secret_key_from_limbs(ctx, want["sk"])
    got = tbfv.Ciphertext.from_stacked(ctx, torch.from_numpy(ranks[S][0][f"ct_mul/{name}"]),
                                       ctx.ciphertext_context)
    assert tbfv.decode(ctx, tbfv.decrypt(got, sk)) == want["product"]


@pytest.mark.parametrize("S", WORLDS)
def test_every_rank_returns_every_case(ranks, S):
    keys = set(ranks[S][0])
    assert len(ranks[S]) == S and all(set(out) == keys for out in ranks[S])
    assert keys == {f"{kind}/{k}" for kind, table in (("ntt", NTT_CASES), ("limb", LIMB_CASES), ("ct_mul", CT_MUL_CASES))
                    for k, v in table.items() if v[2] == S}


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_block_tables_are_the_local_stages(blocks):
    """ops/ntt.build_block_tables on one process: the first log2 S stages
    done as exact butterflies on the whole polynomial, then each block's
    plain transform with its tables, give the unsharded NTT; and the
    inverse, with n^-1 applied after the block transforms."""
    from she_tpu_torch.ops.modarith import add_mod, mul_mod, sub_mod
    from she_tpu_torch.ops import wide

    n, moduli = 64, W64[:2]
    cpu = torch.device("cpu")
    tables = ntt.build_ntt_tables(moduli, n, cpu)
    q = wide.tag(tables.q.view(2, 1, 1), moduli)
    x = torch.from_numpy(_residues(moduli, n, 5))
    y = x.clone()
    log2s = blocks.bit_length() - 1
    for log2m in range(log2s):  # the plain forward's first stages
        m, t = 1 << log2m, n >> (log2m + 1)
        v = y.reshape(2, m, 2, t)
        wb = mul_mod(v[..., 1, :], tables.roots[:, m : 2 * m, None], q)
        y = torch.stack((add_mod(v[..., 0, :], wb, q), sub_mod(v[..., 0, :], wb, q)), dim=-2).reshape(2, n)
    nb = n // blocks
    fwd = torch.cat([ntt.forward_ntt_plain(y[:, d * nb : (d + 1) * nb].contiguous(),
                                           ntt.build_block_tables(moduli, n, blocks, d, cpu))
                     for d in range(blocks)], dim=-1)
    assert torch.equal(fwd, ntt.forward_ntt_plain(x, tables))
    back = torch.cat([ntt.inverse_ntt_plain(fwd[:, d * nb : (d + 1) * nb].contiguous(),
                                            ntt.build_block_tables(moduli, n, blocks, d, cpu))
                      for d in range(blocks)], dim=-1)
    for log2m in reversed(range(log2s)):
        m, t = 1 << log2m, n >> (log2m + 1)
        v = back.reshape(2, m, 2, t)
        a, b = v[..., 0, :], v[..., 1, :]
        lo, hi = add_mod(a, b, q), mul_mod(sub_mod(a, b, q), tables.inv_roots[:, m : 2 * m, None], q)
        back = torch.stack((lo, hi), dim=-2).reshape(2, n)
    q1 = wide.tag(tables.q.view(2, 1), moduli)
    # the last stage (m = 1, across blocks or in the block's transform)
    # carried w^-1 but not n^-1: n^-1 on both halves
    back = mul_mod(back, tables.n_inv, q1)
    assert torch.equal(back, x)


class _Mesh:
    def __init__(self, **sizes):
        self.shape = sizes

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return 0


@pytest.mark.parametrize("S,n", [(3, 64), (4, 4), (8, 4)])
def test_sharded_ntt_refuses_an_axis_it_cannot_split(S, n):
    tables = ntt.build_ntt_tables(W32[:1], n, torch.device("cpu"))
    with pytest.raises(errors.InvalidArgument):
        sharded.ShardedNtt(_Mesh(n=S), tables, "n")


def test_block_tables_refuse_a_bad_split():
    with pytest.raises(ValueError):
        ntt.build_block_tables(W32[:1], 64, 3, 0, torch.device("cpu"))
    with pytest.raises(ValueError):
        ntt.build_block_tables(W32[:1], 64, 4, 4, torch.device("cpu"))
