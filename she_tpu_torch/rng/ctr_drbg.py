"""NIST SP 800-90A CTR_DRBG (AES-128, no derivation function).

The same state machine as she_tpu.rng.ctr_drbg, so seeded ciphertexts expand
byte-for-byte like the reference's
(Sources/HomomorphicEncryption/Random/NistCtrDrbg.swift:25-110,
BufferedRng.swift:17-67, NistAes128Ctr.swift:17-40).

AES-128 is implemented here in numpy, vectorized over the counter blocks of
one keystream request, so the port needs no cryptography package: a request
of B blocks costs ten rounds of table lookups and XORs on a [B, 16] byte
array. CTR mode increments the full 16-byte counter big-endian, as the
reference's swift-crypto AES._CTR does.
"""

from __future__ import annotations

import os

import numpy as np

_BLOCK = 16
_KEYLEN = 16
_SEEDLEN = _KEYLEN + _BLOCK  # 32
_MASK64 = (1 << 64) - 1
_MASK128 = (1 << 128) - 1


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _make_sbox() -> np.ndarray:
    """FIPS-197 S-box: multiplicative inverse in GF(2^8), then the affine map."""
    exp = [0] * 255
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= _xtime(x)  # multiply by the generator 3
    sbox = [0x63] * 256
    for a in range(1, 256):
        inv = exp[(255 - log[a]) % 255]
        s = inv
        for shift in range(1, 5):
            s ^= ((inv << shift) | (inv >> (8 - shift))) & 0xFF
        sbox[a] = s ^ 0x63
    return np.array(sbox, dtype=np.uint8)


_SBOX = _make_sbox()
_MUL2 = np.array([_xtime(a) for a in range(256)], dtype=np.uint8)
# State bytes in input order: index 4*c + r is row r of column c.
# ShiftRows: new[r][c] = old[r][(c + r) % 4].
_SHIFT_ROWS = np.array([4 * ((i // 4 + i % 4) % 4) + i % 4 for i in range(16)])
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _expand_key(key: bytes) -> np.ndarray:
    """AES-128 key schedule -> [11, 16] round keys in state byte order."""
    words = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(words[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [int(_SBOX[b]) for b in t]
            t[0] ^= _RCON[i // 4 - 1]
        words.append([a ^ b for a, b in zip(words[i - 4], t)])
    return np.array(words, dtype=np.uint8).reshape(11, 16)


def aes128_encrypt_blocks(key: bytes, blocks: np.ndarray) -> np.ndarray:
    """AES-128 encryption of a [B, 16] uint8 array of blocks."""
    rk = _expand_key(key)
    s = blocks ^ rk[0]
    for rnd in range(1, 11):
        s = _SBOX[s][:, _SHIFT_ROWS]
        if rnd != 10:
            a = s.reshape(-1, 4, 4)  # [B, column, row]
            a1 = np.roll(a, -1, axis=2)
            a2 = np.roll(a, -2, axis=2)
            a3 = np.roll(a, -3, axis=2)
            s = (_MUL2[a] ^ _MUL2[a1] ^ a1 ^ a2 ^ a3).reshape(-1, 16)
        s = s ^ rk[rnd]
    return s


def _counter_blocks(counter: int, count: int) -> np.ndarray:
    """[count, 16] big-endian 128-bit counters counter, counter+1, ..."""
    lo0 = np.uint64(counter & _MASK64)
    hi0 = np.uint64((counter >> 64) & _MASK64)
    lo = lo0 + np.arange(count, dtype=np.uint64)  # wraps mod 2^64
    hi = hi0 + (lo < lo0).astype(np.uint64)
    out = np.empty((count, 2), dtype=">u8")
    out[:, 0] = hi
    out[:, 1] = lo
    return out.view(np.uint8).reshape(count, 16)


def _aes_ctr_keystream(key: bytes, counter: int, nbytes: int) -> bytes:
    """AES-128-CTR keystream of nbytes, counter as 128-bit big-endian."""
    count = -(-nbytes // _BLOCK)
    stream = aes128_encrypt_blocks(key, _counter_blocks(counter & _MASK128, count))
    return stream.tobytes()[:nbytes]


class NistCtrDrbg:
    """CTR_DRBG state machine (key, V, reseed counter).

    The reference keeps `nonce` = V and always encrypts with counter V+1
    (NistCtrDrbg.swift:45-50), then advances V by the number of blocks.
    """

    RESEED_INTERVAL = 1 << 48
    MAX_BYTES_PER_REQUEST = 1 << 16

    def __init__(self, entropy: bytes | None = None):
        if entropy is None:
            entropy = os.urandom(_SEEDLEN)
        if len(entropy) != _SEEDLEN:
            raise ValueError(f"entropy must be {_SEEDLEN} bytes")
        self.key = bytes(_KEYLEN)
        self.v = 0
        self.reseed_counter = 1
        self._update(entropy)

    def _update(self, provided: bytes) -> None:
        stream = _aes_ctr_keystream(self.key, (self.v + 1) & _MASK128, _SEEDLEN)
        self.key = bytes(a ^ b for a, b in zip(stream[:_KEYLEN], provided[:_KEYLEN]))
        self.v = int.from_bytes(
            bytes(a ^ b for a, b in zip(stream[_KEYLEN:], provided[_KEYLEN:])), "big"
        )

    def generate(self, count: int) -> bytes:
        if self.reseed_counter > self.RESEED_INTERVAL:
            raise RuntimeError("CTR_DRBG reseed interval exceeded")
        if count > self.MAX_BYTES_PER_REQUEST:
            raise ValueError(f"request of {count} bytes exceeds {self.MAX_BYTES_PER_REQUEST}")
        out = _aes_ctr_keystream(self.key, (self.v + 1) & _MASK128, count)
        self.v = (self.v + (count + _BLOCK - 1) // _BLOCK) & _MASK128
        self._update(b"\x00" * _SEEDLEN)
        self.reseed_counter += 1
        return out


class BufferedRng:
    """4096-byte buffered stream over a generator, matching BufferedRng.swift.

    Because each `generate` call mutates DRBG state, the buffering pattern
    is part of the byte-stream contract: consumers see the concatenation of
    successive generate(4096) outputs.
    """

    BUFFER_BYTES = 4096

    def __init__(self, rng: NistCtrDrbg):
        self.rng = rng
        self._buf = b""
        self._off = 0

    def random_bytes(self, n: int) -> bytes:
        chunks = []
        need = n
        while need > 0:
            if self._off == len(self._buf):
                self._buf = self.rng.generate(self.BUFFER_BYTES)
                self._off = 0
            take = min(need, len(self._buf) - self._off)
            chunks.append(self._buf[self._off : self._off + take])
            self._off += take
            need -= take
        return b"".join(chunks)

    def next_u64(self) -> int:
        return int.from_bytes(self.random_bytes(8), "little")

    def next_u32(self) -> int:
        return int.from_bytes(self.random_bytes(4), "little")


def nist_aes128_ctr(seed: bytes) -> BufferedRng:
    """The reference's NistAes128Ctr = BufferedRng<NistCtrDrbg> with 4096-byte buffer."""
    return BufferedRng(NistCtrDrbg(seed))


class SystemRng:
    """os.urandom-backed RNG with the same interface (non-reproducible)."""

    def random_bytes(self, n: int) -> bytes:
        return os.urandom(n)

    def next_u64(self) -> int:
        return int.from_bytes(os.urandom(8), "little")

    def next_u32(self) -> int:
        return int.from_bytes(os.urandom(4), "little")
