"""The key switch's passes (she_tpu_torch/ops/key_switch.py) against she_tpu
and against Python integers, bit for bit, on the CPU.

Each plain version meets its she_tpu counterpart on the same numpy-seeded
inputs at insecure_n_8_logq_5x18_logt_5, at 32- and 64-bit scalars:
ks_digits she_tpu's signed Galois gather (ops/galois.py:61) and its digit
reduction (bfv/keys.py:294-312, reduce_u32 / reduce_u64_any where q_j >
q_i); ks_finish divide_and_round_q_last (core/poly.py:207), the gather and
the add; expand_combine the add, sub and multiply_power_of_x of an
expansion level (pir/serving.py:160-167); ks_mac, which she_tpu computes
only inside its key switch, through compute_key_switching_update. Each
also meets a Python big-int computation at moduli near 2^62 with
q_j > q_i (the negate-then-reduce order) and at L_t = 17 (a MAC sum that
passes 2^128 unless reduced part-way). The restructured apply_galois,
relinearize and expand_stacked meet she_tpu over an expansion tree whose
first level applies its key twice. The CUDA wrappers' refusals are
checked here too; the kernels themselves are held to these plain
versions on the card by tests/test_torch_key_switch_kernels.py. Every
comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.core import context as jctxmod
from she_tpu.core import poly as jpoly
from she_tpu.ops import galois as jgalois
from she_tpu.ops import word as wordmod
from she_tpu.pir import index_pir as jip
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch import trace
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.bfv import keys as tkeys
from she_tpu_torch.core import context as tctxmod
from she_tpu_torch.ops import key_switch as ks
from she_tpu_torch.ops import key_switch_cuda as kc
from she_tpu_torch.ops import ntt as tntt
from she_tpu_torch.pir import serving as tserving
from she_tpu_torch.utils import nt

PARAMS = "insecure_n_8_logq_5x18_logt_5"
N = 8
CPU = torch.device("cpu")
KS_OPS = ("ks_digits", "ks_mac", "ks_finish", "expand_combine", "expand_leaves", "mod_switch")
# near 2^62, q_0 > q_1 (so (q_0 - a) mod q_1 != q_1 - (a mod q_1)), q_ks last
BIG = tuple(nt.generate_primes([62, 61, 62], preferring_small=False, ntt_degree=N))
BIG17 = tuple(nt.generate_primes([62] * 18, preferring_small=False, ntt_degree=N))


def _moduli(bits):
    """(ciphertext moduli, q_ks) of the set."""
    moduli = tparams.from_predefined(PARAMS, bits).coefficient_moduli
    return tuple(moduli[:-1]), moduli[-1]


def _rand(moduli, batch=(), seed=0, degree=N):
    rng = np.random.default_rng(seed)
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        out[..., i, :] = rng.integers(0, q, size=tuple(batch) + (degree,), dtype=np.int64)
    return out


def _tctx(moduli, bits):
    return tctxmod.get_poly_context(N, tuple(moduli), bits, CPU)


def _jp(values, moduli, bits):
    ctx = jctxmod.get_poly_context(values.shape[-1], tuple(moduli), bits)
    return jpoly.PolyRq.from_values(values.astype(object), ctx, jpoly.COEFF)


def _jv(data) -> np.ndarray:
    """A she_tpu PolyRq or word -> int64 [..., L, N]."""
    data = data.data if hasattr(data, "data") else np.stack([np.asarray(w) for w in data])
    return wordmod.unpack(np.asarray(data)).astype(np.int64)


def _jgather(values, moduli, bits, element):
    """she_tpu's apply_galois_coeff of [L, N] values (bfv.py:814-840's call)."""
    p = _jp(values, moduli, bits)
    qw = wordmod.as_word(jnp.asarray(p.context.q_arr))
    return _jv(jgalois.apply_galois_coeff(p.word(), qw, element, p.context.word))


def _jreduce(row_values, q_from, key_modulus, bits):
    """she_tpu's digit step for one row (keys.py:294-312): reduced mod
    key_modulus by reduce_u32 / reduce_u64_any where q_from > key_modulus,
    else passed through."""
    if q_from <= key_modulus:
        return row_values
    km = jctxmod.get_poly_context(N, (key_modulus,), bits)
    rc = km.row_consts[0]
    row = wordmod.as_word(wordmod.pack(row_values.astype(object), km.nlimbs))
    if km.nlimbs == 1:
        out = wordmod.W32.reduce_u32(row, km.row_word("q", 0), (np.uint32(rc["mu32"]),))
    else:
        cw = {"k": rc["k"], "mu": km.row_word("mu", 0), "mu32": np.uint32(rc["mu32"]),
              "r32": km.row_word("r32", 0), "r32_shoup": km.row_word("r32_shoup", 0)}
        out = wordmod.W64.reduce_u64_any(row, km.row_word("q", 0), cw)
    return _jv(out)


# -- each plain version against she_tpu ---------------------------------------


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("l_t", [1, 2, 4])
@pytest.mark.parametrize("element", [None, 3, 15])
def test_ks_digits_plain_matches_she_tpu(bits, l_t, element):
    ct_moduli, q_ks = _moduli(bits)
    target, ks_moduli = ct_moduli[:l_t], ct_moduli[:l_t] + (q_ks,)
    c1 = _rand(target, seed=10 * l_t + (element or 0))
    image = c1 if element is None else _jgather(c1, target, bits, element)
    want = np.stack([np.stack([_jreduce(image[j], target[j], q, bits) for q in ks_moduli]) for j in range(l_t)])
    got = ks.ks_digits_plain(torch.from_numpy(c1), _tctx(ks_moduli, bits), element)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("mode", ["update", "galois3", "galois15", "relinearize"])
def test_ks_finish_plain_matches_she_tpu(bits, mode):
    ct_moduli, q_ks = _moduli(bits)
    target, ks_moduli = ct_moduli[:3], ct_moduli[:3] + (q_ks,)
    inv = _rand(ks_moduli, batch=(2,), seed=31)
    c0, c1 = _rand(target, seed=32), _rand(target, seed=33)
    u = [jpoly.divide_and_round_q_last(_jp(inv[c], ks_moduli, bits)) for c in range(2)]
    element = {"galois3": 3, "galois15": 15}.get(mode)
    want = [_jv(p) for p in u]
    kwargs = {}
    if mode != "update":
        x0 = c0 if element is None else _jgather(c0, target, bits, element)
        want[0] = _jv(jpoly.add(_jp(x0, target, bits), u[0]))
        kwargs = dict(c0=torch.from_numpy(c0), element=element)
    if mode == "relinearize":
        want[1] = _jv(jpoly.add(_jp(c1, target, bits), u[1]))
        kwargs["c1"] = torch.from_numpy(c1)
    got = ks.ks_finish_plain(torch.from_numpy(inv), _tctx(ks_moduli, bits), **kwargs)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("shift", [1, 2, 4])
def test_expand_combine_plain_matches_she_tpu(bits, shift):
    ct_moduli, _ = _moduli(bits)
    slots, nodes = 7, 2
    pool = _rand(ct_moduli, batch=(slots, 2, 2), seed=40 + shift)
    update = _rand(ct_moduli, batch=(nodes, 2, 2), seed=50 + shift)
    parents, child0, child1 = [1, 4], [2, 5], [3, 6]
    want = pool.copy()
    for r in range(nodes):
        for b in range(2):
            for p in range(2):
                par = _jp(pool[parents[r], b, p], ct_moduli, bits)
                upd = _jp(update[r, b, p], ct_moduli, bits)
                want[child0[r], b, p] = _jv(jpoly.add(upd, par))
                want[child1[r], b, p] = _jv(jpoly.multiply_power_of_x(jpoly.sub(par, upd), -shift))
    got = torch.from_numpy(pool.copy())
    idx = [torch.tensor(v, dtype=torch.int64) for v in (parents, child0, child1)]
    ks.expand_combine_plain(got, torch.from_numpy(update), *idx, shift, _tctx(ct_moduli, bits))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module", params=[32, 64])
def keyed(request):
    """Contexts, a secret key, and an evaluation key with the expansion's
    elements 5 and 3 (not N + 1: level 1 applies 5 twice), 2N - 1 and a
    relinearization key, made by she_tpu and carried across."""
    bits = request.param
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(b"s" * 32))
    config = jkeys.EvaluationKeyConfig((5, 3, 2 * N - 1), has_relinearization_key=True)
    jek = jkeys.generate_evaluation_key(jctx, config, jsk, jrng(b"k" * 32))
    limbs = lambda ct: [np.asarray(p.data) for p in ct.polys]  # noqa: E731
    galois = {e: [limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    cts = []
    for i in range(2):
        values = [int(v) for v in np.random.default_rng(i).integers(0, jctx.plaintext_modulus, size=N)]
        jct = jbfv.encrypt(jbfv.encode(jctx, values), jsk, seed=bytes([i + 1]) * 32, err_rng=jrng(bytes([i + 9]) * 32))
        cts.append((jct, convert.ciphertext_from_limbs(tctx, limbs(jct))))
    return dict(bits=bits, jctx=jctx, tctx=tctx, jek=jek, tek=tek, cts=cts, limbs=limbs)


def _assert_ct(tct, jct, limbs):
    for got, want in zip(convert.ciphertext_to_limbs(tct), limbs(jct), strict=True):
        np.testing.assert_array_equal(got, want)


def test_ks_mac_through_the_key_switching_update(keyed):
    """she_tpu computes the MAC only inside its key switch: the port's
    update (ks_digits, NTT, ks_mac, NTT, ks_finish) equals she_tpu's."""
    jct, tct = keyed["cts"][0]
    jkey = keyed["jek"].relinearization_key.key_switch_key
    tkey = keyed["tek"].relinearization_key.key_switch_key
    want = jkeys.compute_key_switching_update(keyed["jctx"], jct.polys[1], jkey)
    got = tkeys.compute_key_switching_update(keyed["tctx"], tct.polys[1], tkey)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.data.numpy(), convert.limbs_to_int64(np.asarray(w.data)))


@pytest.mark.parametrize("element", [3, 2 * N - 1])
def test_apply_galois_matches_she_tpu(keyed, element):
    jct, tct = keyed["cts"][1]
    _assert_ct(tbfv.apply_galois(tct, element, keyed["tek"]), jbfv.apply_galois(jct, element, keyed["jek"]),
               keyed["limbs"])


def test_relinearize_matches_she_tpu(keyed):
    (ja, ta), (jb, tb) = keyed["cts"]
    want = jbfv.relinearize(jbfv.ct_mul(ja, jb), keyed["jek"])
    _assert_ct(tbfv.relinearize(tbfv.ct_mul(ta, tb), keyed["tek"]), want, keyed["limbs"])


def test_expand_stacked_matches_she_tpu(keyed):
    """8 outputs: three levels with elements 5 (applied twice), 5 and 3;
    each level one key switch a Galois application and one combine."""
    tctx = keyed["tctx"]
    assert tserving.ip.expansion_step_element(keyed["tek"], N, 1) == (5, 2)
    stacked = torch.stack([tct.stacked() for _, tct in keyed["cts"]])  # [2, 2, L, N]
    before = dict(trace.counters)
    got = tserving.expand_stacked(stacked, N, keyed["tek"], tctx)
    ran = {k: trace.counters[k] - before.get(k, 0) for k in ("key_switch", "expansion_level", "leaf_level")}
    # a key switch a level, two at level 1; the last level writes the 8 leaves
    assert ran == {"key_switch": 1 + 2 + 1, "expansion_level": 3, "leaf_level": 1}
    for b, (jct, _) in enumerate(keyed["cts"]):
        want = jip.expand([jct], N, keyed["jek"])
        assert len(want) == got.shape[0]
        for g, w in zip(got[:, b], want):
            np.testing.assert_array_equal(g.numpy(), np.stack(
                [convert.limbs_to_int64(a) for a in keyed["limbs"](w)]))


# -- each plain version against Python integers, near 2^62 --------------------


def _src_neg(element):
    """The reference's GaloisCoeffIterator, as a gather: output k reads
    input src[k], negated where neg[k]."""
    src, neg = [0] * N, [False] * N
    for i in range(N):
        raw = i * element
        src[raw % N], neg[raw % N] = i, (raw // N) % 2 == 1
    return src, neg


def _ints(a: np.ndarray):
    return a.astype(object)


@pytest.mark.parametrize("element", [None, 3, 13])
def test_ks_digits_plain_big_int(element):
    target = BIG[:2]
    c1 = _rand(target, batch=(2,), seed=60)
    want = np.zeros((2, 2, 3, N), dtype=object)
    src, neg = _src_neg(element) if element else (list(range(N)), [False] * N)
    for b in range(2):
        for j, qj in enumerate(target):
            for k in range(N):
                v = int(c1[b, j, src[k]])
                v = (qj - v) % qj if neg[k] else v  # negate mod q_j first
                for i, qi in enumerate(BIG):
                    want[b, j, i, k] = v % qi
    got = ks.ks_digits_plain(torch.from_numpy(c1), _tctx(BIG, 64), element)
    np.testing.assert_array_equal(_ints(got.numpy()), want)


@pytest.mark.parametrize("moduli", [BIG, BIG17], ids=["L_t=2", "L_t=17"])
def test_ks_mac_plain_big_int(moduli):
    l_t, l_ks = len(moduli) - 1, len(moduli)
    rng = np.random.default_rng(61)
    fwd = np.stack([_rand(moduli, seed=int(s)) for s in rng.integers(0, 1 << 30, size=l_t)])  # [L_t, L_ks, N]
    fwd[0] = np.array(moduli, dtype=np.int64)[:, None] - 1  # the largest residues
    key = np.stack([_rand(moduli, batch=(2,), seed=int(s)) for s in rng.integers(0, 1 << 30, size=l_t)])
    key[0] = np.array(moduli, dtype=np.int64)[:, None] - 1
    want = np.zeros((2, l_ks, N), dtype=object)
    for c in range(2):
        for i, q in enumerate(moduli):
            for k in range(N):
                want[c, i, k] = sum(int(fwd[j, i, k]) * int(key[j, c, i, k]) for j in range(l_t)) % q
    got = ks.ks_mac_plain(torch.from_numpy(fwd), torch.from_numpy(key), _tctx(moduli, 64))
    np.testing.assert_array_equal(_ints(got.numpy()), want)


@pytest.mark.parametrize("mode", ["update", "galois", "relinearize"])
def test_ks_finish_plain_big_int(mode):
    target, q_last = BIG[:2], BIG[-1]
    inv = _rand(BIG, batch=(2,), seed=62)
    c0, c1 = _rand(target, seed=63), _rand(target, seed=64)
    element = 13 if mode == "galois" else None
    src, neg = _src_neg(element) if element else (list(range(N)), [False] * N)
    half = q_last // 2
    want = np.zeros((2, 2, N), dtype=object)
    for c in range(2):
        for i, q in enumerate(target):
            for k in range(N):
                last_plus = (int(inv[c, -1, k]) + half) % q_last
                u = ((int(inv[c, i, k]) + half % q - last_plus % q) * pow(q_last, -1, q)) % q
                if c == 0 and mode != "update":
                    v = int(c0[i, src[k]])
                    u = (u + ((q - v) % q if neg[k] else v)) % q
                if c == 1 and mode == "relinearize":
                    u = (u + int(c1[i, k])) % q
                want[c, i, k] = u
    kwargs = {} if mode == "update" else dict(c0=torch.from_numpy(c0), element=element)
    if mode == "relinearize":
        kwargs["c1"] = torch.from_numpy(c1)
    got = ks.ks_finish_plain(torch.from_numpy(inv), _tctx(BIG, 64), **kwargs)
    np.testing.assert_array_equal(_ints(got.numpy()), want)


@pytest.mark.parametrize("shift", [1, 3, 4])
def test_expand_combine_plain_big_int(shift):
    moduli = BIG[:2]
    pool = _rand(moduli, batch=(5, 2), seed=65)
    update = _rand(moduli, batch=(1, 2), seed=66)
    got = torch.from_numpy(pool.copy())
    ks.expand_combine_plain(got, torch.from_numpy(update), torch.tensor([3]), torch.tensor([0]), torch.tensor([4]),
                            shift, _tctx(moduli, 64))
    want = _ints(pool.copy())
    for p in range(2):
        for i, q in enumerate(moduli):
            par, upd = [int(v) for v in pool[3, p, i]], [int(v) for v in update[0, p, i]]
            for k in range(N):
                want[0, p, i, k] = (upd[k] + par[k]) % q
                d = (par[k] - upd[k]) % q  # multiplied by x^-shift: the word at s goes to s - shift
                dst = k - shift
                want[4, p, i, dst % N] = d if dst >= 0 else (q - d) % q
    np.testing.assert_array_equal(_ints(got.numpy()), want)


# -- dispatch and the wrappers' refusals --------------------------------------


def test_strided_and_indexed_operands():
    """ks_digits and ks_finish read c0 and c1 through their strides, and the
    slot pool through an index, as the expansion passes them."""
    ct_moduli, q_ks = _moduli(32)
    ctx = _tctx(ct_moduli[:2] + (q_ks,), 32)
    pool = torch.from_numpy(_rand(ct_moduli[:2], batch=(6, 3, 2), seed=70))  # [slots, B, 2, L_t, N]
    index = torch.tensor([4, 1])
    got = ks.ks_digits(pool[:, :, 1], ctx, 3, index)
    assert torch.equal(got, ks.ks_digits_plain(pool.index_select(0, index)[:, :, 1].contiguous(), ctx, 3))
    inv = torch.from_numpy(_rand(ctx.moduli, batch=(2, 3, 2), seed=71))
    got = ks.ks_finish(inv, ctx, pool[:, :, 0], None, 3, index)
    assert torch.equal(got, ks.ks_finish_plain(inv, ctx, pool.index_select(0, index)[:, :, 0].contiguous(), None, 3))
    assert not any(trace.counters["plain_on_cuda." + op] for op in KS_OPS)


def _cpu_args():
    moduli = (17, 97, 113)
    return moduli, torch.zeros((2, 2, N), dtype=torch.int64)


def test_wrappers_refuse_cpu_tensors():
    moduli, c1 = _cpu_args()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.ks_digits(c1, moduli)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.ks_mac(torch.zeros((2, 2, 3, N), dtype=torch.int64), torch.zeros((2, 2, 3, N), dtype=torch.int64), moduli)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.ks_finish(torch.zeros((2, 2, 3, N), dtype=torch.int64), moduli)
    idx = torch.tensor([0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.expand_combine(torch.zeros((3, 2, 2, N), dtype=torch.int64), torch.zeros((1, 2, 2, N), dtype=torch.int64),
                          idx, idx + 1, idx + 2, 1, moduli[:2])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64])
def test_wrappers_refuse_dtypes(dtype):
    moduli, _ = _cpu_args()
    with pytest.raises(TypeError, match="int64"):
        kc.ks_digits(torch.zeros((2, 2, N), dtype=dtype), moduli)
    with pytest.raises(TypeError, match="int64"):
        kc.ks_mac(torch.zeros((2, 2, 3, N), dtype=dtype), torch.zeros((2, 2, 3, N), dtype=torch.int64), moduli)


def test_wrappers_refuse_shapes_and_arguments():
    moduli, _ = _cpu_args()
    with pytest.raises(ValueError, match="power-of-two N"):
        kc.ks_digits(torch.zeros((2, 2, 12), dtype=torch.int64), moduli)
    with pytest.raises(ValueError, match="moduli"):
        kc.ks_digits(torch.zeros((2, 2, N), dtype=torch.int64), (17, 97, 1 << 62))
    with pytest.raises(ValueError, match="power-of-two N"):
        kc.ks_digits(torch.zeros((2, 2, 1 << 14), dtype=torch.int64), moduli)
    with pytest.raises(ValueError, match="no addend, c0 with a Galois element"):
        kc.ks_finish(torch.zeros((2, 2, 3, N), dtype=torch.int64), moduli, element=3)
    with pytest.raises(ValueError, match="shift"):
        idx = torch.tensor([0])
        kc.expand_combine(torch.zeros((3, 2, 2, N), dtype=torch.int64), torch.zeros((1, 2, 2, N), dtype=torch.int64),
                          idx, idx + 1, idx + 2, N, moduli[:2])
    with pytest.raises(ValueError, match="Galois element"):
        kc._pinv(4, N)


@pytest.mark.parametrize("addends", ["c0", "c1", "c1_galois", "c0_c1_galois"])
def test_ks_finish_refuses_adds_no_caller_makes(addends):
    """The kernel is built for the update alone, g(c0) (apply_galois) and
    c0 + c1 (relinearize): every other combination is refused."""
    moduli, c = _cpu_args()
    kwargs = dict(c0=c if "c0" in addends else None, c1=c if "c1" in addends else None,
                  element=3 if "galois" in addends else None)
    with pytest.raises(ValueError, match="no addend, c0 with a Galois element, or c0 and c1 without one"):
        kc.ks_finish(torch.zeros((2, 2, 3, N), dtype=torch.int64), moduli, **kwargs)


@pytest.mark.parametrize("comps", [1, 3])
def test_wrappers_refuse_other_component_counts(comps):
    """Every key-switching key has two components; the kernels take two."""
    moduli, _ = _cpu_args()
    with pytest.raises(ValueError, match=r"key must be \[2, 2, 3, 8\]"):
        kc.ks_mac(torch.zeros((2, 2, 3, N), dtype=torch.int64), torch.zeros((2, comps, 3, N), dtype=torch.int64), moduli)
    with pytest.raises(ValueError, match=r"inv must be \[\.\.\., 2, 3, 8\]"):
        kc.ks_finish(torch.zeros((2, comps, 3, N), dtype=torch.int64), moduli)


@pytest.mark.parametrize("slots", [([0, 1], [2, 3], [4, 0]), ([0, 1], [2, 3], [3, 4]), ([0], [0], [1])],
                         ids=["child_is_parent", "children_repeat", "first_child_is_parent"])
def test_level_slots_must_be_disjoint(slots):
    """expand_combine's kernel writes children while other blocks read
    parents: a level whose child slots overlap is refused."""
    with pytest.raises(ValueError, match="child slots must be distinct"):
        ks.check_level_slots(*slots)


@pytest.mark.parametrize("output_count", [2, 3, 8, 100, 511])
def test_expansion_plans_pass_the_slot_check(output_count):
    """Every level of the served plans passes check_level_slots (which
    _plan_on_device runs), and the plan's children fill new slots: every
    inner node but the root once, every output position once (a leaf
    -position - 1), and a level says it writes leaves exactly where it
    does."""
    tserving._plan_on_device.cache_clear()
    inner_count, levels = tserving._plan_on_device(output_count, CPU)
    written = [int(s) for _, _, c0, c1, _, _ in levels for s in torch.cat([c0, c1])]
    assert len(set(written)) == len(written) == inner_count - 1 + output_count
    assert sorted(written) == list(range(-output_count, 0)) + list(range(1, inner_count))
    assert [leaves for *_, leaves, _ in levels] == [bool((torch.cat([c0, c1]) < 0).any())
                                                    for _, _, c0, c1, _, _ in levels]


def test_dispatch_refuses_other_devices():
    ctx = _tctx((17, 97, 113), 32)
    with pytest.raises(ValueError, match="no ks_digits for device meta"):
        ks.ks_digits(torch.zeros((2, 2, N), dtype=torch.int64, device="meta"), ctx)


def test_constants_are_the_barrett_and_shoup_words():
    table = kc.constants(BIG, CPU).numpy().astype(np.uint64).astype(object)
    q_last = BIG[-1]
    for i, q in enumerate(BIG):
        ratio = (1 << 128) // q
        assert (table[i, 0], table[i, 1], table[i, 2]) == (q, ratio % (1 << 64), ratio >> 64)
        if i < len(BIG) - 1:
            inv = pow(q_last, -1, q)
            assert (table[i, 3], table[i, 4], table[i, 5]) == ((q_last >> 1) % q, inv, (inv << 64) // q)
        assert table[i, 6] == 0  # no fold constant above 2^32
    small = (17, 97, (1 << 28) - 65535)
    folds = kc.constants(small, CPU).numpy()[:, 6]
    assert [int(f) for f in folds] == [((1 << 32) % q << 32) // q for q in small]
    assert kc._pinv(3, N) * 3 % (2 * N) == 1


# -- the key switch's two routes -----------------------------------------------

# (parameter set, or (moduli bits, degree) of generated primes) -> fused?
ROUTE_CASES = {
    "w32 at N = 4096": ("n_4096_logq_27_28_28_logt_5", True),
    "18-bit moduli at N = 8": ("insecure_n_8_logq_5x18_logt_5", True),
    "18-bit moduli at N = 4": (([18] * 3, 4), False),
    "eight 28-bit moduli at N = 4096, the limit": (([28] * 8, 4096), True),
    "w64's 55-bit moduli at N = 8192": ("n_8192_logq_3x55_logt_42", False),
    "28-bit moduli at N = 8192": (([28] * 3, 8192), False),
    "33-bit moduli at N = 4096": ("n_4096_logq_16_33_33_logt_4", False),
    "60-bit moduli at N = 4096": (([60] * 3, 4096), False),
    "nine 28-bit moduli at N = 4096": (([28] * 9, 4096), False),
}


def _route_ctx(source):
    if isinstance(source, str):
        p = tparams.from_predefined(source, 64)
        moduli, degree = p.coefficient_moduli, p.poly_degree
    else:
        bits, degree = source
        moduli = nt.generate_primes(bits, preferring_small=False, ntt_degree=degree)
    return tctxmod.get_poly_context(degree, tuple(moduli), 64, CPU)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_fused_route_choice(case):
    """The fused pair takes the NTT's 32-bit route (every key-switching
    modulus below 2^30) at 8 <= N <= 4096 with at most 8 moduli; every other
    shape keeps the split chain."""
    source, fused = ROUTE_CASES[case]
    ctx = _route_ctx(source)
    assert ks.fused_route(ctx) is fused
    assert kc.fused_shape(ctx.moduli, ctx.degree) is fused


def test_matrix_ntt_opt_in_keeps_the_split_route(monkeypatch):
    """With the matrix NTT's opt-in every NTT goes to ops/ntt_mxu, so the
    key switch keeps the split chain."""
    ctx = _route_ctx("n_4096_logq_27_28_28_logt_5")
    monkeypatch.setenv("SHE_TPU_NTT_MXU", "1")
    assert not ks.fused_route(ctx)


def _route_counts(before):
    return {k: trace.counters[k] - before.get(k, 0) for k in ("key_switch", "key_switch.fused", "key_switch.split")}


def test_expansion_counts_fused_key_switches(keyed):
    """At 18-bit moduli and N = 8 every key switch of an expansion takes
    the fused route; on the CPU its plain passes are the chain's."""
    stacked = torch.stack([tct.stacked() for _, tct in keyed["cts"]])
    before = dict(trace.counters)
    tserving.expand_stacked(stacked, N, keyed["tek"], keyed["tctx"])
    assert _route_counts(before) == {"key_switch": 4, "key_switch.fused": 4, "key_switch.split": 0}


def test_expansion_counts_split_key_switches():
    """At 60-bit moduli every key switch of an expansion (two levels, one
    key switch each) takes the split route."""
    tctx = tbfv.get_bfv_context(tparams.from_predefined("insecure_n_512_logq_4x60_logt_20", 64), device="cpu")
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    sk = tbfv.generate_secret_key(tctx, nist_aes128_ctr(b"s" * 32))
    degree = tctx.degree
    ek = tkeys.generate_evaluation_key(tctx, tkeys.EvaluationKeyConfig((degree + 1, degree // 2 + 1)), sk,
                                       nist_aes128_ctr(b"k" * 32))
    ct = tbfv.encrypt(tbfv.encode(tctx, [1, 2, 3]), sk, seed=b"c" * 32, err_rng=nist_aes128_ctr(b"e" * 32))
    before = dict(trace.counters)
    out = tserving.expand_stacked(ct.stacked().unsqueeze(0), 4, ek, tctx)
    assert _route_counts(before) == {"key_switch": 2, "key_switch.fused": 0, "key_switch.split": 2}
    assert out.shape == (4, 1, 2, 3, degree)


def _fused_args(moduli=(17, 97, 113), degree=N):
    ctx = tctxmod.get_poly_context(degree, moduli, 64, CPU)
    l_t = len(moduli) - 1
    return dict(
        c1=torch.zeros((2, l_t, degree), dtype=torch.int64),
        key=torch.zeros((l_t, 2, l_t + 1, degree), dtype=torch.int32),
        products=torch.zeros((2, 2, l_t + 1, degree), dtype=torch.int32),
        moduli=moduli, tables=ctx.ntt_tables)


def _mac(a):
    return kc.ks_digits_ntt_mac(a["c1"], a["key"], a["moduli"], a["tables"])


def _finish(a):
    return kc.ks_intt_finish(a["products"], a["moduli"], a["tables"])


# refusal -> (which wrapper, what is changed, the error and its message)
FUSED_REFUSALS = {
    "c1 on the CPU": (_mac, {}, ValueError, "CUDA tensor"),
    "products on the CPU": (_finish, {}, ValueError, "CUDA tensor"),
    "c1 int32": (_mac, {"c1": torch.zeros((2, 2, N), dtype=torch.int32)}, TypeError, "int64"),
    "key int64": (_mac, {"key": torch.zeros((2, 2, 3, N), dtype=torch.int64)}, TypeError, "int32"),
    "products int64": (_finish, {"products": torch.zeros((2, 2, 3, N), dtype=torch.int64)}, TypeError, "int32"),
    "key of three components": (_mac, {"key": torch.zeros((2, 3, 3, N), dtype=torch.int32)}, ValueError,
                                r"key must be \[2, 2, 3, 8\]"),
    "products of another L_ks": (_finish, {"products": torch.zeros((2, 2, 4, N), dtype=torch.int32)}, ValueError,
                                 r"products must be \[\.\.\., 2, 3, 8\]"),
}


@pytest.mark.parametrize("case", list(FUSED_REFUSALS))
def test_fused_wrappers_refuse(case):
    wrapper, change, error, message = FUSED_REFUSALS[case]
    args = _fused_args()
    args.update(change)
    with pytest.raises(error, match=message):
        wrapper(args)


@pytest.mark.parametrize("wrapper", [_mac, _finish])
@pytest.mark.parametrize("moduli", [(17, 97, (1 << 30) + 3), ((1 << 30) + 3, 97, 113)])
def test_fused_wrappers_refuse_moduli_from_two_to_the_thirty(wrapper, moduli):
    """A modulus at or above 2^30 is the NTT's 64-bit route: the split chain's."""
    args = _fused_args()
    args["moduli"] = moduli
    with pytest.raises(ValueError, match="below 2"):
        wrapper(args)


@pytest.mark.parametrize("wrapper", [_mac, _finish])
def test_fused_wrappers_refuse_n_8192_and_other_tables(wrapper):
    moduli = tuple(nt.generate_primes([28, 28, 28], preferring_small=False, ntt_degree=8192))
    args = _fused_args()
    args.update(moduli=moduli, c1=torch.zeros((2, 2, 8192), dtype=torch.int64),
                products=torch.zeros((2, 2, 3, 8192), dtype=torch.int32))
    with pytest.raises(ValueError, match="N from 8 up to 4096"):
        wrapper(args)
    args = _fused_args()
    args["tables"] = _fused_args((17, 97, 193))["tables"]
    with pytest.raises(ValueError, match="32-bit NTT tables"):
        wrapper(args)


def test_fused_plain_versions_are_the_chain():
    """ks_digits_ntt_mac_plain and ks_intt_finish_plain give the split
    chain's words (the products as int32)."""
    moduli = tuple(nt.generate_primes([28, 27, 28], preferring_small=False, ntt_degree=N))
    ctx = _tctx(moduli, 64)
    c = torch.from_numpy(_rand(moduli[:-1], batch=(3, 2), seed=71))
    key = torch.from_numpy(_rand(moduli, batch=(2, 2), seed=72))
    for element in (None, 5):
        fwd = ks.ks_mac_plain(tntt.forward_ntt_plain(ks.ks_digits_plain(c[:, 1], ctx, element), ctx.ntt_tables), key, ctx)
        products = ks.ks_digits_ntt_mac_plain(c[:, 1], key.to(torch.int32), ctx, element)
        assert products.dtype == torch.int32 and torch.equal(products.to(torch.int64), fwd)
        c0 = c[:, 0] if element else None
        want = ks.ks_finish_plain(tntt.inverse_ntt_plain(fwd, ctx.ntt_tables), ctx, c0, None, element)
        assert torch.equal(ks.ks_intt_finish_plain(products, ctx, c0, None, element), want)
