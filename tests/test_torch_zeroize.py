"""Secret-material zeroization in the port (mirrors tests/test_zeroize.py;
reference Keys.swift:19-50, Zeroization.swift:1-40).

The port has no immutable device arrays: a secret key's tensor is
overwritten with zeros in place, on the host or on the card, and then
dropped, so any use of the key afterwards raises.
"""

import numpy as np
import pytest
import torch

from she_tpu_torch import errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv
from she_tpu_torch.core.poly import EVAL, PolyRq
from she_tpu_torch.rng.ctr_drbg import NistCtrDrbg, nist_aes128_ctr
from she_tpu_torch.utils.zeroize import zeroize

PARAMS = "insecure_n_8_logq_5x18_logt_5"


def test_zeroize_bytearray_and_numpy():
    buf = bytearray(b"secret material here")
    zeroize(buf)
    assert buf == bytearray(len(buf))
    arr = np.arange(64, dtype=np.uint32) + 1
    zeroize(arr)
    assert not arr.any()
    with pytest.raises(ValueError):
        zeroize(np.arange(8)[::2])
    with pytest.raises(TypeError):
        zeroize(b"immutable")


def test_drbg_zeroize_scrubs_state_and_refuses_reuse():
    rng = nist_aes128_ctr(bytes(range(32)))
    rng.random_bytes(100)
    assert any(rng.rng.key)  # key state is live
    assert any(rng._buf)
    buf = rng._buf
    rng.zeroize()
    assert rng.rng.key == bytes(16)
    assert not any(buf)
    assert int(rng.rng._batch.v_hi[0]) == int(rng.rng._batch.v_lo[0]) == 0
    with pytest.raises(RuntimeError):
        rng.random_bytes(1)  # buffer exhausted -> generate() refuses


def test_drbg_buffer_keeps_nist_stream():
    # the bytearray-backed buffer must not change the stream
    a = NistCtrDrbg(bytes(range(32))).generate(64)
    b = nist_aes128_ctr(bytes(range(32))).random_bytes(64)
    assert a == b and any(a)


@pytest.mark.parametrize("bits", [32, 64])
def test_secret_key_zeroize_scrubs_and_refuses_reuse(bits):
    ctx = bfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    with bfv.generate_secret_key(ctx, nist_aes128_ctr(b"\x01" * 32)) as sk:
        pt = bfv.encode(ctx, [1, 2, 3])
        ct = bfv.encrypt(pt, sk, err_rng=nist_aes128_ctr(b"\x02" * 32))
        assert bfv.decode(ctx, bfv.decrypt(ct, sk))[:3] == [1, 2, 3]
        data = sk.poly.data
        assert bool(data.any())
    # context-manager exit zeroized the key's own storage and dropped it
    assert not bool(data.any())
    with pytest.raises(errors.InvalidArgument):
        sk.poly
    with pytest.raises(errors.InvalidArgument):
        bfv.decrypt(ct, sk)
    sk.zeroize()  # idempotent


def test_secret_key_zeroize_scrubs_host_numpy():
    ctx = bfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    host = np.ones((len(ctx.secret_key_context.moduli), ctx.degree), dtype=np.int64)
    sk = bfv.SecretKey(PolyRq(torch.from_numpy(host), ctx.secret_key_context, EVAL))
    sk.zeroize()
    assert not host.any()


def test_secret_key_scrubbed_when_collected():
    ctx = bfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(b"\x03" * 32))
    data = sk.poly.data
    assert bool(data.any())
    del sk
    assert not bool(data.any())


@pytest.mark.gpu
def test_secret_key_zeroize_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx = bfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cuda")
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(b"\x04" * 32))
    data = sk.poly.data
    assert data.is_cuda and bool(data.any())
    sk.zeroize()
    assert not bool(data.any())
    with pytest.raises(errors.InvalidArgument):
        sk.poly
