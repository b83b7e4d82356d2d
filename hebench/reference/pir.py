"""What a PIR answer has to hold, from the protocol alone.

Index PIR (MulPIR, as the Swift reference packs it): entries of `size`
bytes are packed `per_plaintext = bytes_per_plaintext // size` to a
plaintext, in order; the answer for entry i is plaintext i // per_plaintext
in the coefficient encoding, zero past the entries it holds.

Keyword PIR: the answer for a keyword is one reply per cuckoo hash
function, each the bytes of a hash bucket; a bucket is a u8 slot count and
per slot the keyword's hash (the first 8 bytes of SHA-256 of the keyword,
read as a little-endian u64), a u16-LE value size and the value
(HashBucket.swift). A present keyword's slot sits in one of its replies;
an absent keyword's in none.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import bfv


def index_plaintext(database: np.ndarray, index: int, degree: int, t: int) -> np.ndarray:
    """int64 [N]: the coefficients of the plaintext that holds entry
    `index` of `database` (uint8 [entries, size])."""
    size = database.shape[1]
    bits = bfv.floor_log2(t)
    per_plaintext = bfv.bytes_per_plaintext(degree, t) // size
    first = index // per_plaintext * per_plaintext
    data = database[first : first + per_plaintext].reshape(-1).tobytes()
    return bfv.bytes_to_coefficients(data, bits, degree)


def keyword_hash(keyword: bytes) -> bytes:
    """The 8 bytes a bucket stores for `keyword`."""
    return hashlib.sha256(keyword).digest()[:8]


def find_value(reply: bytes, keyword: bytes) -> bytes | None:
    """The value stored for `keyword` in the bucket bytes of one reply,
    or None: the first place the keyword's hash stands with a value size
    and a value of that size after it."""
    tag = keyword_hash(keyword)
    start = reply.find(tag)
    while start >= 0:
        at = start + len(tag)
        if at + 2 <= len(reply):
            size = int.from_bytes(reply[at : at + 2], "little")
            if at + 2 + size <= len(reply):
                return reply[at + 2 : at + 2 + size]
        start = reply.find(tag, start + 1)
    return None


def keyword_value(replies: list, keyword: bytes, t: int) -> bytes | None:
    """The value a keyword answer gives: `replies` holds, per hash function,
    the decrypted coefficient rows (int [chunks, N]) of its reply."""
    bits = bfv.floor_log2(t)
    for rows in replies:
        data = b"".join(bfv.coefficients_to_bytes(row, bits) for row in rows)
        value = find_value(data, keyword)
        if value is not None:
            return value
    return None
