"""NIST SP 800-90A CTR_DRBG (AES-128, no derivation function).

The same state machine as she_tpu.rng.ctr_drbg, so seeded ciphertexts expand
byte-for-byte like the reference's
(Sources/HomomorphicEncryption/Random/NistCtrDrbg.swift:25-110,
BufferedRng.swift:17-67, NistAes128Ctr.swift:17-40).

AES-128 is implemented here in numpy, vectorized over the counter blocks of
one keystream request, so the port needs no cryptography package: a request
of B blocks costs ten rounds of table lookups and XORs on a [B, 16] byte
array (rounds 1-9 as T-table lookups). The one state machine,
NistCtrDrbgBatch, runs many generators in lockstep, vectorized over their
keys as well (a server expands many seeded ciphertexts at once);
NistCtrDrbg is its single-generator case. CTR mode increments the full
16-byte counter big-endian, as the reference's swift-crypto AES._CTR does.
"""

from __future__ import annotations

import os

import numpy as np

_BLOCK = 16
_KEYLEN = 16
_SEEDLEN = _KEYLEN + _BLOCK  # 32
_MASK64 = (1 << 64) - 1


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


def _expand_keys(keys: np.ndarray) -> np.ndarray:
    """AES-128 key schedule of K keys at once: uint8 [K, 16] -> [K, 11, 16]
    round keys in state byte order."""
    w = np.zeros((keys.shape[0], 44, 4), dtype=np.uint8)
    w[:, :4] = keys.reshape(-1, 4, 4)
    for i in range(4, 44):
        t = w[:, i - 1]
        if i % 4 == 0:
            t = _SBOX[np.roll(t, -1, axis=1)]  # RotWord, SubWord
            t[:, 0] ^= _RCON[i // 4 - 1]
        w[:, i] = w[:, i - 4] ^ t
    return w.reshape(-1, 11, 16)


def _expand_key(key: bytes) -> np.ndarray:
    """AES-128 key schedule -> [11, 16] round keys in state byte order."""
    return _expand_keys(np.frombuffer(key, dtype=np.uint8)[None, :])[0]


def _t_tables() -> tuple:
    """The four T-tables of a middle round, as uint32 columns (row r in
    byte r): T_j[x] is S[x] times MixColumns' column j (2,1,1,3),
    (3,2,1,1), (1,3,2,1), (1,1,3,2)."""
    s1 = _SBOX.astype(np.uint32)
    s2 = _MUL2[_SBOX].astype(np.uint32)
    s3 = s2 ^ s1
    return tuple(
        a | (b << np.uint32(8)) | (c << np.uint32(16)) | (d << np.uint32(24))
        for a, b, c, d in ((s2, s1, s1, s3), (s3, s2, s1, s1), (s1, s3, s2, s1), (s1, s1, s3, s2))
    )


_T = _t_tables()


def _aes_rounds(s: np.ndarray, rk) -> np.ndarray:
    """AES-128 encryption of uint8 [..., 16] blocks; rk[r] is round r's
    key, broadcast against the blocks. Rounds 1-9 are T-table lookups:
    SubBytes, ShiftRows and MixColumns of column c gather byte r of column
    (c + r) % 4 through table r."""
    s = np.ascontiguousarray(s ^ rk[0])
    for rnd in range(1, 10):
        cols = [
            np.take(_T[0], s[..., 4 * c]) ^ np.take(_T[1], s[..., 4 * ((c + 1) % 4) + 1])
            ^ np.take(_T[2], s[..., 4 * ((c + 2) % 4) + 2]) ^ np.take(_T[3], s[..., 4 * ((c + 3) % 4) + 3])
            for c in range(4)
        ]
        # as little-endian words, row r of a column is byte r
        s = np.stack(cols, axis=-1).astype("<u4", copy=False).view(np.uint8) ^ rk[rnd]
    return np.take(_SBOX, s[..., _SHIFT_ROWS]) ^ rk[10]


def aes128_encrypt_blocks(key: bytes, blocks: np.ndarray) -> np.ndarray:
    """AES-128 encryption of a [B, 16] uint8 array of blocks."""
    return _aes_rounds(blocks, _expand_key(key))


def _ctr_keystream(keys: np.ndarray, v_hi: np.ndarray, v_lo: np.ndarray, first: int, blocks: int) -> np.ndarray:
    """uint8 [K, blocks * 16]: AES-128-CTR under K keys [K, 16] of the
    big-endian 128-bit counters V+first, ..., V+first+blocks-1, V given as
    uint64 halves [K] (wrapping mod 2^128)."""
    lo = v_lo[:, None] + np.arange(first, first + blocks, dtype=np.uint64)  # wraps mod 2^64
    hi = v_hi[:, None] + (lo < v_lo[:, None]).astype(np.uint64)
    counters = np.empty(lo.shape + (2,), dtype=">u8")
    counters[..., 0] = hi
    counters[..., 1] = lo
    counters = counters.view(np.uint8).reshape(lo.shape + (16,))
    rk = _expand_keys(keys).transpose(1, 0, 2)[:, :, None, :]  # [11, K, 1, 16]
    return _aes_rounds(counters, rk).reshape(lo.shape[0], -1)


def _aes_ctr_keystream(key: bytes, counter: int, nbytes: int) -> bytes:
    """AES-128-CTR keystream of nbytes, counter as 128-bit big-endian."""
    halves = np.array([[(counter >> 64) & _MASK64, counter & _MASK64]], dtype=np.uint64)
    keys = np.frombuffer(key, dtype=np.uint8)[None, :]
    return _ctr_keystream(keys, halves[:, 0], halves[:, 1], 0, -(-nbytes // _BLOCK)).tobytes()[:nbytes]


class NistCtrDrbgBatch:
    """K CTR_DRBG state machines (key, V, reseed counter) run in lockstep:
    every step does one key schedule of the K keys and one AES pass over
    all their counter blocks, so K streams cost about one numpy pass each
    instead of K. V is kept as two uint64 halves, hi and lo.

    The reference keeps `nonce` = V and always encrypts with counter V+1
    (NistCtrDrbg.swift:45-50), then advances V by the number of blocks.
    """

    RESEED_INTERVAL = 1 << 48
    MAX_BYTES_PER_REQUEST = 1 << 16

    def __init__(self, entropies: list):
        if any(len(e) != _SEEDLEN for e in entropies):
            raise ValueError(f"entropy must be {_SEEDLEN} bytes")
        count = len(entropies)
        self.keys = np.zeros((count, _KEYLEN), dtype=np.uint8)
        self.v_hi = np.zeros(count, dtype=np.uint64)
        self.v_lo = np.zeros(count, dtype=np.uint64)
        self.reseed_counter = 1
        self._update(np.frombuffer(b"".join(entropies), dtype=np.uint8).reshape(count, _SEEDLEN))

    def _update(self, provided: np.ndarray) -> None:
        stream = _ctr_keystream(self.keys, self.v_hi, self.v_lo, 1, 2) ^ provided
        self.keys = stream[:, :_KEYLEN].copy()
        v = stream[:, _KEYLEN:].copy().view(">u8")  # [K, 2] big-endian halves
        self.v_hi = v[:, 0].astype(np.uint64)
        self.v_lo = v[:, 1].astype(np.uint64)

    def generate(self, count: int) -> np.ndarray:
        """uint8 [K, count]: each instance's next `count` bytes."""
        if self.reseed_counter > self.RESEED_INTERVAL:
            raise RuntimeError("CTR_DRBG reseed interval exceeded")
        if count > self.MAX_BYTES_PER_REQUEST:
            raise ValueError(f"request of {count} bytes exceeds {self.MAX_BYTES_PER_REQUEST}")
        blocks = (count + _BLOCK - 1) // _BLOCK
        out = _ctr_keystream(self.keys, self.v_hi, self.v_lo, 1, blocks)[:, :count]
        lo = self.v_lo + np.uint64(blocks)
        self.v_hi = self.v_hi + (lo < self.v_lo).astype(np.uint64)
        self.v_lo = lo
        self._update(np.zeros((len(self.keys), _SEEDLEN), dtype=np.uint8))
        self.reseed_counter += 1
        return out


class NistCtrDrbg:
    """One CTR_DRBG: NistCtrDrbgBatch with K = 1, returning bytes."""

    def __init__(self, entropy: bytes | None = None):
        self._batch = NistCtrDrbgBatch([os.urandom(_SEEDLEN) if entropy is None else entropy])

    @property
    def key(self) -> bytes:
        return self._batch.keys[0].tobytes()

    def generate(self, count: int) -> bytes:
        return self._batch.generate(count)[0].tobytes()


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


def nist_aes128_ctr_streams(seeds: list, nbytes: int) -> np.ndarray:
    """uint8 [len(seeds), nbytes]: the first nbytes each nist_aes128_ctr(seed)
    gives, drawn for all seeds at once. The buffered stream is the
    concatenation of generate(4096) outputs whatever the request sizes."""
    drbg = NistCtrDrbgBatch(seeds)
    steps = -(-nbytes // BufferedRng.BUFFER_BYTES)
    out = np.concatenate([drbg.generate(BufferedRng.BUFFER_BYTES) for _ in range(steps)], axis=1)
    return out[:, :nbytes]


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
