"""MMapDictionary: read-only zero-copy memory-mapped hash dictionary.

A copy of she_tpu/io/mmap_dict.py (host code, no torch): the files it
writes are byte-identical to she_tpu's. Wire-compatible with the reference
(Sources/MemoryMapping/MMapDictionary.swift):
* header: u32-LE magic (0x4D4D4150 "MMAP" for u32 offsets, 0x4D4D4151 "MMAQ"
  for u64) + u32-LE bucket count
* bucket table: per bucket u32 hash prefix + u32/u64 entry offset (0 = empty)
* entries: u32 key length + key + u32 value length + value
* FNV-1a 64-bit hashing, linear probing, at least 16 buckets.
"""

from __future__ import annotations

import math
import mmap
import os
import struct
from dataclasses import dataclass, field

MAGIC_U32 = 0x4D4D4150
MAGIC_U64 = 0x4D4D4151
HEADER_SIZE = 8
DEFAULT_LOAD_FACTOR = 0.75

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


class MMapDictionaryError(Exception):
    pass


def fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


@dataclass
class MMapDictionaryBuilder:
    """Collects pairs, emits the binary format (MMapDictionary.swift:353-545)."""

    entries: list = field(default_factory=list)

    def insert(self, key: bytes, value: bytes):
        self.entries.append((bytes(key), bytes(value)))

    def _bucket_count(self, load_factor: float) -> int:
        if not 0.0 < load_factor <= 1.0:
            raise MMapDictionaryError("load factor must be in (0, 1]")
        return max(math.ceil(len(self.entries) / load_factor), 16)

    def build(self, load_factor: float = DEFAULT_LOAD_FACTOR) -> bytes:
        bucket_count = self._bucket_count(load_factor)
        entries_size = sum(8 + len(k) + len(v) for k, v in self.entries)
        # try u32 offsets first; fall back to u64 when the file is too large
        for offset_size, magic in ((4, MAGIC_U32), (8, MAGIC_U64)):
            bucket_entry = 4 + offset_size
            total = HEADER_SIZE + bucket_count * bucket_entry + entries_size
            if offset_size == 4 and total > 0xFFFFFFFF:
                continue
            return self._build_with(offset_size, magic, bucket_count)
        raise MMapDictionaryError("unreachable")

    def _build_with(self, offset_size: int, magic: int, bucket_count: int) -> bytes:
        bucket_entry = 4 + offset_size
        buckets = [(0, 0)] * bucket_count
        current = HEADER_SIZE + bucket_count * bucket_entry
        for key, value in self.entries:
            h = fnv1a(key)
            prefix = h & 0xFFFFFFFF
            probe = h % bucket_count
            start = probe
            while buckets[probe][1] != 0:
                probe = (probe + 1) % bucket_count
                if probe == start:
                    raise MMapDictionaryError("bucket table is full")
            buckets[probe] = (prefix, current)
            current += 8 + len(key) + len(value)
        out = bytearray()
        out += struct.pack("<II", magic, bucket_count)
        fmt = "<II" if offset_size == 4 else "<IQ"
        for prefix, offset in buckets:
            out += struct.pack(fmt, prefix, offset)
        for key, value in self.entries:
            out += struct.pack("<I", len(key)) + key
            out += struct.pack("<I", len(value)) + value
        return bytes(out)

    def write(self, path: str, load_factor: float = DEFAULT_LOAD_FACTOR):
        data = self.build(load_factor)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)


class MMapDictionary:
    """Read-only lookup over a memory-mapped dictionary file."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview, mmap.mmap)):
            self._buf = path_or_bytes
            self._file = None
        else:
            self._file = open(path_or_bytes, "rb")
            self._buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self._buf) < HEADER_SIZE:
            raise MMapDictionaryError("file too small")
        magic, bucket_count = struct.unpack_from("<II", self._buf, 0)
        if magic == MAGIC_U32:
            self.offset_size = 4
        elif magic == MAGIC_U64:
            self.offset_size = 8
        else:
            raise MMapDictionaryError("invalid magic number")
        if bucket_count <= 0:
            raise MMapDictionaryError("invalid bucket count")
        self.bucket_count = bucket_count
        self._bucket_fmt = "<II" if self.offset_size == 4 else "<IQ"
        self._bucket_entry = 4 + self.offset_size

    def close(self):
        if self._file is not None:
            self._buf.close()
            self._file.close()
            self._file = None

    def _bucket(self, index: int):
        off = HEADER_SIZE + index * self._bucket_entry
        if off + self._bucket_entry > len(self._buf):
            raise MMapDictionaryError("invalid bucket offset")
        return struct.unpack_from(self._bucket_fmt, self._buf, off)

    def get(self, key: bytes) -> bytes | None:
        h = fnv1a(key)
        prefix = h & 0xFFFFFFFF
        start = h % self.bucket_count
        probe = start
        while True:
            stored_prefix, entry_offset = self._bucket(probe)
            if entry_offset == 0:
                return None
            if stored_prefix == prefix:
                (key_len,) = struct.unpack_from("<I", self._buf, entry_offset)
                kstart = entry_offset + 4
                candidate = bytes(self._buf[kstart : kstart + key_len])
                if candidate == key:
                    voff = kstart + key_len
                    (value_len,) = struct.unpack_from("<I", self._buf, voff)
                    vstart = voff + 4
                    return bytes(self._buf[vstart : vstart + value_len])
            probe = (probe + 1) % self.bucket_count
            if probe == start:
                return None

    def count(self) -> int:
        """Number of stored entries (diagnostics)."""
        n = 0
        for i in range(self.bucket_count):
            if self._bucket(i)[1] != 0:
                n += 1
        return n

    def longest_probe_run(self) -> int:
        """Longest run of consecutive occupied buckets (diagnostics)."""
        occupied = [self._bucket(i)[1] != 0 for i in range(self.bucket_count)]
        if all(occupied):
            return self.bucket_count
        longest = run = 0
        for v in occupied + occupied:  # wraparound
            if v:
                run += 1
                longest = max(longest, run)
            else:
                run = 0
        return min(longest, self.bucket_count)

    def items(self):
        for i in range(self.bucket_count):
            _, off = self._bucket(i)
            if off == 0:
                continue
            (key_len,) = struct.unpack_from("<I", self._buf, off)
            key = bytes(self._buf[off + 4 : off + 4 + key_len])
            voff = off + 4 + key_len
            (value_len,) = struct.unpack_from("<I", self._buf, voff)
            yield key, bytes(self._buf[voff + 4 : voff + 4 + value_len])
