"""The port's MMapDictionary (she_tpu_torch.io.mmap_dict) against she_tpu's:
FNV-1a, the files the builders write (u32 and u64 offsets, load factors,
empty values, binary keys) byte for byte, and each reader over the other's
file (the port's side of test_tools.py's MMapDictionary tests)."""

import numpy as np
import pytest

from she_tpu.io import mmap_dict as jmd
from she_tpu_torch.io import mmap_dict as tmd


def _rows(count, seed):
    rng = np.random.default_rng(seed)
    rows = {}
    for i in range(count):
        key = rng.integers(0, 256, size=int(rng.integers(0, 12)), dtype=np.uint8).tobytes() + i.to_bytes(3, "little")
        rows[key] = rng.integers(0, 256, size=int(rng.integers(0, 20)), dtype=np.uint8).tobytes()
    return rows


def _builders(rows):
    jb, tb = jmd.MMapDictionaryBuilder(), tmd.MMapDictionaryBuilder()
    for k, v in rows.items():
        jb.insert(k, v)
        tb.insert(k, v)
    return jb, tb


@pytest.mark.parametrize("length", [0, 1, 7, 64])
def test_fnv1a(length):
    data = np.random.default_rng(length).integers(0, 256, size=length, dtype=np.uint8).tobytes()
    assert tmd.fnv1a(data) == jmd.fnv1a(data)


@pytest.mark.parametrize("load_factor", [0.5, 0.75, 1.0])
@pytest.mark.parametrize("count", [0, 1, 100, 300])
def test_builder_bytes_equal_she_tpu(count, load_factor):
    jb, tb = _builders(_rows(count, count))
    data = tb.build(load_factor)
    assert data == jb.build(load_factor)
    assert data[:4] == tmd.MAGIC_U32.to_bytes(4, "little")


def test_u64_offsets_equal_she_tpu():
    jb, tb = _builders(_rows(40, 3))
    buckets = tb._bucket_count(0.75)
    data = tb._build_with(8, tmd.MAGIC_U64, buckets)
    assert data == jb._build_with(8, jmd.MAGIC_U64, buckets)
    d = tmd.MMapDictionary(data)
    assert d.offset_size == 8 and d.count() == 40
    assert dict(d.items()) == dict(jmd.MMapDictionary(data).items())


def test_empty_values_and_binary_keys(tmp_path):
    rows = {b"\x00\xff": b"", b"": b"x", b"\x00" * 5: b"\x01\x02"}
    jb, tb = _builders(rows)
    jb.write(str(tmp_path / "j.mmap"))
    tb.write(str(tmp_path / "t.mmap"))
    assert (tmp_path / "t.mmap").read_bytes() == (tmp_path / "j.mmap").read_bytes()
    d = tmd.MMapDictionary(str(tmp_path / "j.mmap"))
    for k, v in rows.items():
        assert d.get(k) == v
    assert d.get(b"missing") is None
    d.close()


def test_readers_agree_on_each_others_files(tmp_path):
    rows = _rows(200, 11)
    jb, tb = _builders(rows)
    jb.write(str(tmp_path / "j.mmap"))
    tb.write(str(tmp_path / "t.mmap"))
    td, jd = tmd.MMapDictionary(str(tmp_path / "j.mmap")), jmd.MMapDictionary(str(tmp_path / "t.mmap"))
    assert (td.count(), td.longest_probe_run(), td.bucket_count) == (jd.count(), jd.longest_probe_run(), jd.bucket_count)
    for k, v in rows.items():
        assert td.get(k) == jd.get(k) == v
    assert dict(td.items()) == rows
    td.close()
    jd.close()


@pytest.mark.parametrize("data", [b"", b"\x00" * 7, (0x12345678).to_bytes(4, "little") + bytes(4)])
def test_invalid_files_raise(data):
    with pytest.raises(tmd.MMapDictionaryError):
        tmd.MMapDictionary(data)
    with pytest.raises(tmd.MMapDictionaryError):
        tmd.MMapDictionaryBuilder().build(0.0)
