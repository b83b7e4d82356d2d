"""The PNNS half of the port's proto conversion against she_tpu's, byte
for byte: matrix packings, plaintext matrices (Coeff and Eval), ciphertext
matrices (seeded queries and mod-switched responses), client and server
configs (with an extra plaintext modulus), and the vector database; and
each message read back into the port's objects."""

import numpy as np
import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.io import pb as jpb
from she_tpu.io import proto_conversion as jpc
from she_tpu.pnns import pnns as jpnns
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.core.poly import COEFF
from she_tpu_torch.io import pb as tpb
from she_tpu_torch.io import proto_conversion as tpc
from she_tpu_torch.pnns import pnns as tpnns

PARAMS = "insecure_n_8_logq_5x18_logt_5"


def _seed(tag):
    return (tag * 32)[:32]


@pytest.fixture(scope="module")
def env():
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 32))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    tsk = convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data))
    return dict(jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk)


def _packings(kind):
    if kind == "diagonal":
        return (jpnns.MatrixPacking.diagonal(jpnns.BabyStepGiantStep.create(3)),
                tpnns.MatrixPacking.diagonal(tpnns.BabyStepGiantStep.create(3)))
    if kind == "denseRow":
        return jpnns.MatrixPacking.dense_row(), tpnns.MatrixPacking.dense_row()
    return jpnns.MatrixPacking.dense_column(), tpnns.MatrixPacking.dense_column()


@pytest.mark.parametrize("kind", ["denseRow", "denseColumn", "diagonal"])
def test_matrix_packing_bytes(kind):
    jpacking, tpacking = _packings(kind)
    raw = tpc.matrix_packing_to_proto(tpacking).SerializeToString()
    assert raw == jpc.matrix_packing_to_proto(jpacking).SerializeToString()
    assert tpc.matrix_packing_from_proto(tpb.pnns_pb2.MatrixPacking.FromString(raw)) == tpacking


@pytest.mark.parametrize("kind,to_eval", [("denseRow", False), ("denseColumn", False), ("diagonal", True)])
def test_plaintext_matrix_bytes(env, kind, to_eval):
    jpacking, tpacking = _packings(kind)
    values = [int(v) for v in np.random.default_rng(1).integers(0, 17, size=9)]
    jm = jpnns.PlaintextMatrix.from_values(env["jctx"], jpnns.MatrixDimensions(3, 3), jpacking, values)
    tm = tpnns.PlaintextMatrix.from_values(env["tctx"], tpnns.MatrixDimensions(3, 3), tpacking, values)
    if to_eval:
        jm, tm = jm.to_eval(), tm.to_eval()
    raw = tpc.plaintext_matrix_to_proto(tm).SerializeToString()
    assert raw == jpc.plaintext_matrix_to_proto(jm).SerializeToString()
    back = tpc.plaintext_matrix_from_proto(tpb.pnns_pb2.SerializedPlaintextMatrix.FromString(raw), env["tctx"],
                                           fmt="eval" if to_eval else COEFF)
    assert (back.dimensions, back.packing) == (tm.dimensions, tm.packing)
    for got, want in zip(back.plaintexts, tm.plaintexts, strict=True):
        assert got.poly.fmt == want.poly.fmt and (got.poly.data == want.poly.data).all()
    assert back.unpack() == values


def _carry_matrix(tctx, jmatrix, tpacking, moduli_count=None):
    cts = [convert.ciphertext_from_limbs(tctx, [np.asarray(p.data) for p in ct.polys], ct.fmt,
                                         ct.correction_factor, ct.seed) for ct in jmatrix.ciphertexts]
    return tpnns.CiphertextMatrix(tpnns.MatrixDimensions(jmatrix.row_count, jmatrix.column_count), tpacking, cts,
                                  tctx)


def test_ciphertext_matrix_bytes(env):
    """A seeded query matrix (seeds carried, so both write the seeded form)
    and a mod-switched response matrix (the full form)."""
    values = [int(v) for v in np.random.default_rng(2).integers(0, 17, size=6)]
    jpacking, tpacking = _packings("denseRow")
    jm = jpnns.PlaintextMatrix.from_values(env["jctx"], jpnns.MatrixDimensions(2, 3), jpacking, values)
    jct = jm.encrypt(env["jsk"], err_rng=jrng(_seed(b"e")))
    tct = _carry_matrix(env["tctx"], jct, tpacking)
    raw = tpc.ciphertext_matrix_to_proto(tct).SerializeToString()
    assert raw == jpc.ciphertext_matrix_to_proto(jct).SerializeToString()
    msg = tpb.pnns_pb2.SerializedCiphertextMatrix.FromString(raw)
    assert all(c.WhichOneof("serialized_ciphertext_type") == "seeded" for c in msg.ciphertexts)
    back = tpc.ciphertext_matrix_from_proto(msg, env["tctx"])
    for got, want in zip(back.ciphertexts, tct.ciphertexts, strict=True):
        assert (got.stacked() == want.stacked()).all()
    assert back.decrypt(env["tsk"]).unpack() == values

    jresp = jct.mod_switch_down_to_single()
    tresp = _carry_matrix(env["tctx"], jresp, tpacking)
    raw = tpc.ciphertext_matrix_to_proto(tresp).SerializeToString()
    assert raw == jpc.ciphertext_matrix_to_proto(jresp).SerializeToString()
    back = tpc.ciphertext_matrix_from_proto(tpb.pnns_pb2.SerializedCiphertextMatrix.FromString(raw), env["tctx"],
                                            moduli_count=1)
    assert back.ciphertexts[0].moduli_count == 1
    assert back.decrypt(env["tsk"]).unpack() == values


@pytest.mark.parametrize("extra", [(), (97,)])
@pytest.mark.parametrize("bits", [32, 64])
def test_client_and_server_config_bytes(env, extra, bits):
    jep, tep = jparams.from_predefined(PARAMS, bits), tparams.from_predefined(PARAMS, bits)
    configs = []
    for pkg, ctx, ep in ((jpnns, env["jctx"], jep), (tpnns, env["tctx"], tep)):
        ek_config = pkg.matmul_evaluation_key_config(ctx, pkg.MatrixDimensions(5, 3), 2)
        client = pkg.ClientConfig.create(ep, 123, pkg.MatrixPacking.dense_row(), 3, ek_config,
                                         extra_plaintext_moduli=extra)
        configs.append((client, pkg.ServerConfig(client, pkg.MatrixPacking.diagonal(pkg.BabyStepGiantStep.create(3)))))
    (jclient, jserver), (tclient, tserver) = configs
    raw = tpc.pnns_client_config_to_proto(tclient).SerializeToString()
    assert raw == jpc.pnns_client_config_to_proto(jclient).SerializeToString()
    assert tpc.pnns_client_config_from_proto(tpb.pnns_pb2.ClientConfig.FromString(raw), bits) == tclient
    raw = tpc.pnns_server_config_to_proto(tserver).SerializeToString()
    assert raw == jpc.pnns_server_config_to_proto(jserver).SerializeToString()
    assert tpc.pnns_server_config_from_proto(tpb.pnns_pb2.ServerConfig.FromString(raw), bits) == tserver
    # she_tpu reads the port's bytes to the same config
    assert jpc.pnns_server_config_from_proto(jpb.pnns_pb2.ServerConfig.FromString(raw), bits) == jserver


def test_database_bytes():
    rows = [(1, b"meta", [1.0, 2.0, -0.25]), (2, b"", [0.5, -1.5, 3.0]), (7, b"\x00\x01", [0.0, 0.0, 0.0])]
    jdb = jpnns.Database([jpnns.DatabaseRow(i, m, np.array(v, dtype=np.float32)) for i, m, v in rows])
    tdb = tpnns.Database([tpnns.DatabaseRow(i, m, np.array(v, dtype=np.float32)) for i, m, v in rows])
    raw = tpc.pnns_database_to_proto(tdb).SerializeToString()
    assert raw == jpc.pnns_database_to_proto(jdb).SerializeToString()
    back = tpc.pnns_database_from_proto(tpb.pnns_pb2.Database.FromString(raw))
    for got, (i, m, v) in zip(back.rows, rows, strict=True):
        assert (got.entry_id, got.entry_metadata) == (i, m)
        assert got.vector.dtype == np.float32
        np.testing.assert_array_equal(got.vector, np.array(v, dtype=np.float32))
