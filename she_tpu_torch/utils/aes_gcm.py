"""AES-GCM (NIST SP 800-38D) with a 96-bit nonce, a 128-bit tag and no
associated data: the entry encryption of Symmetric PIR.

SymmetricPirConfigType OPRF_P384_AES_GCM_192_NONCE_96_TAG_128 seals each
database value under a 24-byte key (AES-192) derived per row from the
OPRF output; 16-byte keys work too. The block cipher is the port's
one AES (rng/ctr_drbg.aes_encrypt_blocks, numpy); GHASH multiplies in
GF(2^128) on Python ints. `seal` returns ciphertext || tag, as
cryptography's AESGCM.encrypt does, and `unseal` checks the tag before it
returns the plaintext. Rows are short (a value and its bucket framing), so
neither is on a served path's hot loop.
"""

from __future__ import annotations

import hmac

import numpy as np

from ..rng.ctr_drbg import aes_encrypt_blocks

NONCE_BYTES = 12
TAG_BYTES = 16
_BLOCK = 16
_R = 0xE1 << 120  # x^128 + x^7 + x^2 + x + 1, bit-reflected


class InvalidTag(ValueError):
    """The sealed bytes do not authenticate under the key and nonce."""


def _gf_mult(x: int, y: int) -> int:
    """x * y in GCM's GF(2^128), blocks as big-endian ints (SP 800-38D
    Algorithm 1)."""
    z, v = 0, y
    for i in range(127, -1, -1):
        if (x >> i) & 1:
            z ^= v
        v = (v >> 1) ^ _R if v & 1 else v >> 1
    return z


def _ghash(h: int, data: bytes) -> int:
    """GHASH_H over data, zero-padded to whole blocks, then the length
    block of empty associated data and `data`."""
    padded = data + bytes(-len(data) % _BLOCK) + (0).to_bytes(8, "big") + (8 * len(data)).to_bytes(8, "big")
    y = 0
    for i in range(0, len(padded), _BLOCK):
        y = _gf_mult(y ^ int.from_bytes(padded[i : i + _BLOCK], "big"), h)
    return y


def _keystream_and_masks(key: bytes, nonce: bytes, nbytes: int) -> tuple[bytes, int, bytes]:
    """One AES pass over [0^128, J0, inc32(J0), ...]: the hash key H, the
    tag mask E_K(J0) and `nbytes` of GCTR keystream."""
    if len(nonce) != NONCE_BYTES:
        raise ValueError(f"the nonce is {NONCE_BYTES} bytes, got {len(nonce)}")
    count = -(-nbytes // _BLOCK)
    blocks = np.zeros((count + 2, _BLOCK), dtype=np.uint8)
    blocks[1:, :NONCE_BYTES] = np.frombuffer(nonce, dtype=np.uint8)
    counters = (np.arange(1, count + 2, dtype=np.uint64) & np.uint64(0xFFFFFFFF)).astype(">u4")
    blocks[1:, NONCE_BYTES:] = counters.view(np.uint8).reshape(-1, 4)  # J0 = nonce || 1, then inc32
    out = aes_encrypt_blocks(key, blocks).tobytes()
    return out[2 * _BLOCK : 2 * _BLOCK + nbytes], int.from_bytes(out[:_BLOCK], "big"), out[_BLOCK : 2 * _BLOCK]


def _xor(a: bytes, b: bytes) -> bytes:
    return (int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).to_bytes(len(a), "big") if a else b""


def seal(key: bytes, nonce: bytes, plaintext: bytes) -> bytes:
    """AES-GCM authenticated encryption: ciphertext || 16-byte tag."""
    stream, h, mask = _keystream_and_masks(key, nonce, len(plaintext))
    ciphertext = _xor(bytes(plaintext), stream)
    tag = (_ghash(h, ciphertext) ^ int.from_bytes(mask, "big")).to_bytes(TAG_BYTES, "big")
    return ciphertext + tag


def unseal(key: bytes, nonce: bytes, sealed: bytes) -> bytes:
    """AES-GCM authenticated decryption of ciphertext || tag; raises
    InvalidTag if the tag does not match."""
    sealed = bytes(sealed)
    if len(sealed) < TAG_BYTES:
        raise InvalidTag("sealed bytes shorter than the tag")
    ciphertext, tag = sealed[:-TAG_BYTES], sealed[-TAG_BYTES:]
    stream, h, mask = _keystream_and_masks(key, nonce, len(ciphertext))
    want = (_ghash(h, ciphertext) ^ int.from_bytes(mask, "big")).to_bytes(TAG_BYTES, "big")
    if not hmac.compare_digest(tag, want):
        raise InvalidTag("AES-GCM tag mismatch")
    return _xor(ciphertext, stream)
