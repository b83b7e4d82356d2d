"""VOPRF(P-384, SHA-384) per RFC 9497, with RFC 9380 hash-to-curve.

The port's copy of she_tpu/pir/oprf.py: the verifiable oblivious PRF of
Symmetric PIR in pure Python on hashlib (reference:
Sources/PrivateInformationRetrieval/SymmetricPir/SymmetricPirProtocol.swift:20-135,
which uses swift-crypto's P384._VOPRF = RFC 9497 ciphersuite P384-SHA384,
mode VOPRF 0x01).

Curve arithmetic runs on the host in Python big ints. Element wire format
is SEC1 compressed (49 bytes); scalars are 48-byte big-endian. One full
evaluation (hash to curve, one scalar multiplication, finalize) costs tens
of milliseconds of host time, which bounds how many rows Symmetric PIR
processing can seal in a run.

**VARIABLE-TIME**: the double-and-add scalar ladder and Python big-int
arithmetic branch on secret key/blind bits (the reference's equivalent of
`variableTime: true`, Scalar.swift:203-208). See docs/SIDE_CHANNELS.md for
the exposure analysis; the reference instead delegates to swift-crypto's
constant-time P384._VOPRF (SymmetricPirProtocol.swift:20-30).

Correctness anchors: RFC 9380 J.2.1 hash-to-curve vector, RFC 9497 A.4
DeriveKeyPair vector, and she_tpu's implementation for fixed blinds and
proof nonces (tests/test_torch_symmetric_pir.py).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

# --- P-384 curve parameters -------------------------------------------------

P = 2**384 - 2**128 - 2**96 + 2**32 - 1
A = -3 % P
B = int(
    "b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013875a"
    "c656398d8a2ed19d2a85c8edd3ec2aef",
    16,
)
N = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372ddf"
    "581a0db248b0a77aecec196accc52973",
    16,
)
GX = int(
    "aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e082542a38"
    "5502f25dbf55296c3a545e3872760ab7",
    16,
)
GY = int(
    "3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0b8c0"
    "0a60b1ce1d7e819d7a431d7c90ea0e5f",
    16,
)

IDENTITY = None  # point at infinity


def _inv(x: int) -> int:
    return pow(x, -1, P)


def point_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1 + A) * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_mul(k: int, p):
    k %= N
    result = None
    addend = p
    while k:
        if k & 1:
            result = point_add(result, addend)
        addend = point_add(addend, addend)
        k >>= 1
    return result


def point_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % P)


GENERATOR = (GX, GY)


def serialize_element(p) -> bytes:
    """SEC1 compressed, 49 bytes."""
    if p is None:
        raise ValueError("cannot serialize identity")
    x, y = p
    return bytes([2 + (y & 1)]) + x.to_bytes(48, "big")


def deserialize_element(data: bytes):
    if len(data) != 49 or data[0] not in (2, 3):
        raise ValueError("invalid compressed element")
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    alpha = (pow(x, 3, P) + A * x + B) % P
    y = pow(alpha, (P + 1) // 4, P)
    if y * y % P != alpha:
        raise ValueError("not on curve")
    if y & 1 != data[0] & 1:
        y = P - y
    return (x, y)


def serialize_scalar(s: int) -> bytes:
    return (s % N).to_bytes(48, "big")


# --- RFC 9380 hash-to-curve (P384_XMD:SHA-384_SSWU_RO_) ---------------------


def _expand_message_xmd(
    msg: bytes, dst: bytes, length: int, hash_fn=hashlib.sha384
) -> bytes:
    """RFC 9380 §5.3.1. hash_fn parameterized so the RFC's SHA-256 expander
    vectors (§K.1) can exercise the same code path the suite uses."""
    b_in_bytes = hash_fn().digest_size
    s_in_bytes = hash_fn().block_size
    ell = -(-length // b_in_bytes)
    assert ell <= 255 and len(dst) <= 255
    dst_prime = dst + bytes([len(dst)])
    msg_prime = (
        b"\x00" * s_in_bytes + msg + length.to_bytes(2, "big") + b"\x00" + dst_prime
    )
    b0 = hash_fn(msg_prime).digest()
    bi = hash_fn(b0 + b"\x01" + dst_prime).digest()
    out = bi
    for i in range(2, ell + 1):
        xored = bytes(a ^ b for a, b in zip(b0, bi))
        bi = hash_fn(xored + bytes([i]) + dst_prime).digest()
        out += bi
    return out[:length]


def _hash_to_field(msg: bytes, dst: bytes, count: int, modulus: int) -> list[int]:
    L = 72  # ceil((384 + 192) / 8)
    data = _expand_message_xmd(msg, dst, count * L)
    return [
        int.from_bytes(data[i * L : (i + 1) * L], "big") % modulus for i in range(count)
    ]


_SSWU_Z = (-12) % P


def _sgn0(x: int) -> int:
    return x & 1


def _is_square(x: int) -> bool:
    return x == 0 or pow(x, (P - 1) // 2, P) == 1


def _sqrt(x: int) -> int:
    return pow(x, (P + 1) // 4, P)


def _map_to_curve_sswu(u: int):
    Z = _SSWU_Z
    u2 = u * u % P
    tv1 = (Z * Z * u2 * u2 + Z * u2) % P
    if tv1 == 0:
        x1 = B * _inv(Z * A % P) % P
    else:
        x1 = (-B % P) * _inv(A) % P * (1 + _inv(tv1)) % P
    gx1 = (pow(x1, 3, P) + A * x1 + B) % P
    x2 = Z * u2 * x1 % P
    gx2 = (pow(x2, 3, P) + A * x2 + B) % P
    if _is_square(gx1):
        x, y = x1, _sqrt(gx1)
    else:
        x, y = x2, _sqrt(gx2)
    if _sgn0(u) != _sgn0(y):
        y = P - y
    return (x, y)


def hash_to_curve(msg: bytes, dst: bytes):
    u = _hash_to_field(msg, dst, 2, P)
    q0 = _map_to_curve_sswu(u[0])
    q1 = _map_to_curve_sswu(u[1])
    return point_add(q0, q1)


# --- RFC 9497 VOPRF ---------------------------------------------------------

MODE_VOPRF = 0x01
_SUITE = b"P384-SHA384"
CONTEXT_STRING = b"OPRFV1-" + bytes([MODE_VOPRF]) + b"-" + _SUITE


def _hash_to_group(msg: bytes):
    return hash_to_curve(msg, b"HashToGroup-" + CONTEXT_STRING)


def _hash_to_scalar(msg: bytes, dst_prefix: bytes = b"HashToScalar-") -> int:
    return _hash_to_field(msg, dst_prefix + CONTEXT_STRING, 1, N)[0]


def _i2osp2(n: int) -> bytes:
    return n.to_bytes(2, "big")


def _finalize_hash(input_bytes: bytes, unblinded: bytes) -> bytes:
    transcript = (
        _i2osp2(len(input_bytes))
        + input_bytes
        + _i2osp2(len(unblinded))
        + unblinded
        + b"Finalize"
    )
    return hashlib.sha384(transcript).digest()[:48]


def _compute_composites(k: int | None, b_point, c_points, d_points):
    """RFC 9497 Sec 2.2.1; with k -> fast path."""
    bm = serialize_element(b_point)
    seed_dst = b"Seed-" + CONTEXT_STRING
    seed = hashlib.sha384(_i2osp2(len(bm)) + bm + _i2osp2(len(seed_dst)) + seed_dst).digest()
    m_point = None
    z_point = None
    for i, (c, d) in enumerate(zip(c_points, d_points)):
        ci = serialize_element(c)
        di = serialize_element(d)
        transcript = (
            _i2osp2(len(seed))
            + seed
            + _i2osp2(i)
            + _i2osp2(len(ci))
            + ci
            + _i2osp2(len(di))
            + di
            + b"Composite"
        )
        e = _hash_to_scalar(transcript)
        m_point = point_add(m_point, point_mul(e, c))
        if k is None:
            z_point = point_add(z_point, point_mul(e, d))
    if k is not None:
        z_point = point_mul(k, m_point)
    return m_point, z_point


def _challenge(b_point, m_point, z_point, t2, t3) -> int:
    parts = b""
    for pt in (b_point, m_point, z_point, t2, t3):
        s = serialize_element(pt)
        parts += _i2osp2(len(s)) + s
    return _hash_to_scalar(parts + b"Challenge")


def generate_proof(k: int, a_point, b_point, c_points, d_points, r: int | None = None) -> bytes:
    m_point, z_point = _compute_composites(k, b_point, c_points, d_points)
    if r is None:
        r = (int.from_bytes(os.urandom(64), "big") % (N - 1)) + 1
    t2 = point_mul(r, a_point)
    t3 = point_mul(r, m_point)
    c = _challenge(b_point, m_point, z_point, t2, t3)
    s = (r - c * k) % N
    return serialize_scalar(c) + serialize_scalar(s)


def verify_proof(a_point, b_point, c_points, d_points, proof: bytes) -> bool:
    if len(proof) != 96:
        return False
    c = int.from_bytes(proof[:48], "big")
    s = int.from_bytes(proof[48:], "big")
    if c >= N or s >= N:
        return False
    m_point, z_point = _compute_composites(None, b_point, c_points, d_points)
    t2 = point_add(point_mul(s, a_point), point_mul(c, b_point))
    t3 = point_add(point_mul(s, m_point), point_mul(c, z_point))
    return _challenge(b_point, m_point, z_point, t2, t3) == c


def derive_key_pair(seed: bytes, info: bytes, mode: int = MODE_VOPRF) -> int:
    """RFC 9497 §3.2 DeriveKeyPair for the P384-SHA384 ciphersuite.
    Verified against the RFC's Appendix A.4 key-derivation vectors
    (Seed = 0xa3*32, KeyInfo = "test key")."""
    context = b"OPRFV1-" + bytes([mode]) + b"-" + _SUITE
    derive_input = seed + _i2osp2(len(info)) + info
    for counter in range(256):
        sk = _hash_to_field(
            derive_input + bytes([counter]), b"DeriveKeyPair" + context, 1, N
        )[0]
        if sk != 0:
            return sk
    raise ValueError("DeriveKeyPairError: no valid scalar in 256 attempts")


@dataclass
class BlindedInput:
    """Client state: the input, blind scalar, and blinded element."""

    input_bytes: bytes
    blind: int
    blinded_element: bytes  # serialized

    @property
    def query(self) -> bytes:
        return self.blinded_element


@dataclass
class BlindEvaluation:
    evaluated_element: bytes  # serialized
    proof: bytes


class OprfPrivateKey:
    def __init__(self, raw: bytes | None = None):
        if raw is None:
            raw = serialize_scalar((int.from_bytes(os.urandom(64), "big") % (N - 1)) + 1)
        if len(raw) != 48:
            raise ValueError("OPRF private key must be 48 bytes")
        self.k = int.from_bytes(raw, "big")
        if not 0 < self.k < N:
            raise ValueError("invalid OPRF private key scalar")

    @property
    def raw_representation(self) -> bytes:
        return serialize_scalar(self.k)

    @property
    def public_key(self) -> "OprfPublicKey":
        return OprfPublicKey(serialize_element(point_mul(self.k, GENERATOR)))

    def blind_evaluate(self, blinded_element: bytes, proof_r: int | None = None) -> BlindEvaluation:
        """Server: evaluate on a blinded element + DLEQ proof."""
        blinded = deserialize_element(blinded_element)
        evaluated = point_mul(self.k, blinded)
        proof = generate_proof(
            self.k, GENERATOR, point_mul(self.k, GENERATOR), [blinded], [evaluated], proof_r
        )
        return BlindEvaluation(serialize_element(evaluated), proof)

    def evaluate(self, input_bytes: bytes) -> bytes:
        """Server: full evaluation on a raw input (database processing)."""
        element = _hash_to_group(input_bytes)
        if element is None:
            raise ValueError("input maps to identity")
        evaluated = point_mul(self.k, element)
        return _finalize_hash(input_bytes, serialize_element(evaluated))


class OprfPublicKey:
    def __init__(self, compressed: bytes):
        self.point = deserialize_element(compressed)

    @property
    def oprf_representation(self) -> bytes:
        return serialize_element(self.point)

    def blind(self, input_bytes: bytes, blind: int | None = None) -> BlindedInput:
        element = _hash_to_group(input_bytes)
        if element is None:
            raise ValueError("input maps to identity")
        if blind is None:
            blind = (int.from_bytes(os.urandom(64), "big") % (N - 1)) + 1
        blinded = point_mul(blind, element)
        return BlindedInput(input_bytes, blind, serialize_element(blinded))

    def finalize(self, blinded_input: BlindedInput, evaluation: BlindEvaluation) -> bytes:
        blinded = deserialize_element(blinded_input.blinded_element)
        evaluated = deserialize_element(evaluation.evaluated_element)
        if not verify_proof(GENERATOR, self.point, [blinded], [evaluated], evaluation.proof):
            raise ValueError("invalid DLEQ proof")
        inv_blind = pow(blinded_input.blind, -1, N)
        unblinded = point_mul(inv_blind, evaluated)
        return _finalize_hash(blinded_input.input_bytes, serialize_element(unblinded))
