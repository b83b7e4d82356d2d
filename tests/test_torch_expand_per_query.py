"""The per-query expansion (index_pir.expand, served level by level through
pir/expansion.py) against she_tpu's expand and against the port's
node-by-node expand_ciphertext, bit for bit, on the CPU.

Query ciphertexts are encrypted by she_tpu from numpy-seeded values at
insecure_n_8_logq_5x18_logt_5 and carried across with its keys. Output
counts 1, 2, 3, 5, 8 (= N) and 11 (= N + 3: two ciphertexts) at 32 bits,
3 and 5 doubling some leaves; an evaluation key with the elements 9, 5
and 3, and one without 9, so the first level applies 5 twice
(apply_count 2). At 64 bits she_tpu's eager expansion takes seconds an
output count, so she_tpu meets one count there (3, with the key without
9) and the node-by-node route the others. Each case also counts the
levels and key switches the expansion ran: one key switch a Galois
application of a level, one expand_combine a level. Every comparison is
exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.pir import index_pir as jip
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import errors as terrors
from she_tpu_torch import params as tparams
from she_tpu_torch import trace
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.bfv import keys as tkeys
from she_tpu_torch.core.poly import EVAL, PolyRq
from she_tpu_torch.pir import expansion
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import serving as tserving

torch.set_num_threads(1)

PARAMS = "insecure_n_8_logq_5x18_logt_5"
N = 8
KEYS = {"full": (9, 5, 3), "no_9": (5, 3)}


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _setup(bits, elements):
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(b"q" * 32))
    jek = jkeys.generate_evaluation_key(jctx, jkeys.EvaluationKeyConfig(elements), jsk, jrng(b"e" * 32))
    tek = convert.evaluation_key_from_limbs(
        tctx, {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}, None)
    cts = []
    for i in range(2):
        values = [int(v) for v in np.random.default_rng(40 + i).integers(0, jctx.plaintext_modulus, size=N)]
        jct = jbfv.encrypt(jbfv.encode(jctx, values), jsk, seed=bytes([i + 3]) * 32, err_rng=jrng(bytes([i + 5]) * 32))
        cts.append((jct, convert.ciphertext_from_limbs(tctx, _limbs(jct))))
    return dict(jek=jek, tek=tek, cts=cts)


@pytest.fixture(scope="module", params=list(KEYS))
def keyed32(request):
    return _setup(32, KEYS[request.param])


@pytest.fixture(scope="module")
def keyed64():
    return _setup(64, KEYS["no_9"])


def _expected_levels(counts, apply_count):
    """(levels, levels writing leaves, key switches) of expanding each
    ciphertext into its count of outputs."""
    levels = leaf_levels = switches = 0
    for n in counts:
        if n == 1:
            continue
        _, plan = expansion._plan_on_device(n, torch.device("cpu"))
        levels += len(plan)
        leaf_levels += sum(1 for level in plan if level[4])
        switches += len(plan) + (apply_count - 1)  # the first level applies its element apply_count times
    return levels, leaf_levels, switches


def _port_expand(keyed, count):
    """The port's per-query expand, with the levels and key switches it ran."""
    tcts = [t for _, t in keyed["cts"]][: -(-count // N)]
    before = dict(trace.counters)
    got = tip.expand(tcts, count, keyed["tek"])
    ran = {k: trace.counters[k] - before.get(k, 0) for k in ("expansion_level", "leaf_level", "key_switch")}
    counts = [min(N, count - N * i) for i in range(len(tcts))]
    _, apply_count = expansion.expansion_step_element(keyed["tek"], N, 1)
    levels, leaf_levels, switches = _expected_levels(counts, apply_count)
    assert ran == {"expansion_level": levels, "leaf_level": leaf_levels, "key_switch": switches}
    return tcts, got


def _node_by_node(tcts, count, tek):
    out = []
    for ct in tcts:
        n = min(N, count - len(out))
        out.extend(tip.expand_ciphertext(ct, n, 1, max(n - 1, 0).bit_length(), tek))
    return out


def _she_tpu_values(cts) -> list:
    return [np.stack([convert.limbs_to_int64(a) for a in _limbs(c)]) for c in cts]


def _port_values(cts) -> list:
    return [np.stack([p.data.numpy() for p in c.polys]) for c in cts]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(_port_values(got), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("count", [1, 2, 3, 5, N, N + 3])
def test_expand_matches_she_tpu_and_node_by_node(keyed32, count):
    tcts, got = _port_expand(keyed32, count)
    jcts = [j for j, _ in keyed32["cts"]][: len(tcts)]
    _assert_same(got, _she_tpu_values(jip.expand(jcts, count, keyed32["jek"])))
    _assert_same(got, _port_values(_node_by_node(tcts, count, keyed32["tek"])))
    assert all(c.fmt == tcts[0].fmt and c.poly_context() is tcts[0].poly_context() for c in got)


def test_expand_w64_matches_she_tpu(keyed64):
    """3 outputs (one leaf doubled; the first level applies 5 twice) at
    64 bits against she_tpu's expand."""
    tcts, got = _port_expand(keyed64, 3)
    _assert_same(got, _she_tpu_values(jip.expand([keyed64["cts"][0][0]], 3, keyed64["jek"])))


@pytest.mark.parametrize("count", [2, 5, N, N + 3])
def test_expand_w64_matches_node_by_node(keyed64, count):
    tcts, got = _port_expand(keyed64, count)
    _assert_same(got, _port_values(_node_by_node(tcts, count, keyed64["tek"])))


def test_expand_refuses_what_she_tpu_refuses(keyed32):
    """A count the ciphertexts cannot give, an Eval ciphertext and a key
    without the expansion's elements."""
    tct = keyed32["cts"][0][1]
    with pytest.raises(terrors.PirError):
        tip.expand([tct], N + 1, keyed32["tek"])
    with pytest.raises(terrors.PirError):
        tip.expand([tct, tct], N, keyed32["tek"])
    teval = tbfv.Ciphertext(tct.context, [PolyRq(p.data, p.context, EVAL) for p in tct.polys])
    with pytest.raises(terrors.InvalidFormat):
        tip.expand([teval], 2, keyed32["tek"])
    assert tip.expand([teval], 1, keyed32["tek"])[0].fmt == EVAL  # one output: no Galois step, as she_tpu
    for bare in (tkeys.EvaluationKey(), tkeys.EvaluationKey(galois_key=tkeys.GaloisKey({}))):
        with pytest.raises(terrors.MissingGaloisKey):
            tip.expand([tct], 2, bare)
