"""Keyword PIR: cuckoo-hashed keyword -> value lookup over MulPIR.

The port of she_tpu/pir/keyword_pir.py (reference Sources/
PrivateInformationRetrieval/KeywordPir/{KeywordPirProtocol,CuckooTable,
HashBucket,KeywordDatabase}.swift): the same bucket bytes (u8 slot count;
per slot u64-LE keyword hash, u16-LE value size, value), the same
SHA256-derived bucket and shard indices, and a CuckooTable that builds
she_tpu's table for the same `random.Random`: the same evictions, the same
expansions and the same draws from the rng in the same order.

The table keeps a running serialized size per bucket, a map from each
stored keyword to its bucket and the candidate buckets of each keyword at
the current table size, where she_tpu recomputes sizes and scans buckets on
every probe; the choices are the same.

**VARIABLE-TIME (client side)**: `HashBucket.find`'s early-exit scan and
`hash_indices`' rejection loop branch on the client's keyword; both run
only on the client over its own data (the server sees an encrypted index).
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass

import numpy as np
import torch

from .. import errors
from ..bfv import bfv
from ..io import coeffs as coeffio
from . import index_pir as ip

MAX_SLOT_COUNT = 255
MAX_VALUE_SIZE = 0xFFFF


# ---------------------------------------------------------------------------
# Keyword hashing (HashBucket.swift:209-269)
# ---------------------------------------------------------------------------


def keyword_hash(keyword: bytes) -> int:
    """First 8 bytes of SHA256(keyword) as little-endian u64."""
    return int.from_bytes(hashlib.sha256(keyword).digest()[:8], "little")


def index_from_hash(kw_hash: int, bucket_count: int, counter: int) -> int:
    h = hashlib.sha256(kw_hash.to_bytes(8, "big") + bytes([counter])).digest()
    return int.from_bytes(h[:8], "little") % bucket_count


def hash_indices(keyword: bytes, bucket_count: int, hash_function_count: int) -> list:
    """Unique candidate bucket indices (up to 10 retries per function)."""
    kw_hash = keyword_hash(keyword)
    candidates: list = []
    for _ in range(hash_function_count):
        counter = 0
        idx = index_from_hash(kw_hash, bucket_count, counter)
        while idx in candidates and counter < 10:
            counter += 1
            idx = index_from_hash(kw_hash, bucket_count, counter)
        candidates.append(idx)
    return candidates


# ---------------------------------------------------------------------------
# HashBucket (HashBucket.swift:19-205)
# ---------------------------------------------------------------------------


def hash_bucket_entry_size(value_size: int) -> int:
    return 8 + 2 + value_size


def hash_bucket_size(value_sizes) -> int:
    return 1 + sum(hash_bucket_entry_size(v) for v in value_sizes)


def hash_bucket_single_size(value_size: int) -> int:
    return 1 + hash_bucket_entry_size(value_size)


@dataclass
class HashBucket:
    slots: list  # (keyword_hash, value)

    def serialize(self) -> bytes:
        if len(self.slots) > MAX_SLOT_COUNT:
            raise errors.PirError("too many bucket slots")
        out = [bytes([len(self.slots)])]
        for kw_hash, value in self.slots:
            if len(value) > MAX_VALUE_SIZE:
                raise errors.PirError("bucket value too large")
            out.append(kw_hash.to_bytes(8, "little"))
            out.append(len(value).to_bytes(2, "little"))
            out.append(value)
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "HashBucket":
        if not data:
            raise errors.PirError("empty bucket data")
        count = data[0]
        offset = 1
        slots = []
        for _ in range(count):
            if offset + 10 > len(data):
                raise errors.PirError("truncated bucket")
            kw_hash = int.from_bytes(data[offset : offset + 8], "little")
            offset += 8
            vsize = int.from_bytes(data[offset : offset + 2], "little")
            offset += 2
            if offset + vsize > len(data):
                raise errors.PirError("truncated bucket value")
            slots.append((kw_hash, data[offset : offset + vsize]))
            offset += vsize
        return cls(slots)

    def serialized_size(self) -> int:
        return hash_bucket_size(len(v) for _, v in self.slots)

    def find(self, kw_hash: int) -> bytes | None:
        for h, value in self.slots:
            if h == kw_hash:
                return value
        return None


# ---------------------------------------------------------------------------
# Cuckoo table (CuckooTable.swift)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CuckooBucketConfig:
    """Bucket count strategy: expansion (factor, load) or a fixed size."""

    kind: str  # 'allowExpansion' | 'fixedSize'
    expansion_factor: float = 1.1
    target_load_factor: float = 0.9
    bucket_count: int = 0


@dataclass(frozen=True)
class CuckooTableConfig:
    hash_function_count: int
    max_eviction_count: int
    max_serialized_bucket_size: int
    bucket_count: CuckooBucketConfig
    multiple_tables: bool = True
    slot_count: int = MAX_SLOT_COUNT

    @classmethod
    def default_keyword_pir(cls, max_serialized_bucket_size: int) -> "CuckooTableConfig":
        return cls(
            hash_function_count=2,
            max_eviction_count=100,
            max_serialized_bucket_size=max_serialized_bucket_size,
            bucket_count=CuckooBucketConfig("allowExpansion", 1.1, 0.9),
        )

    def freezing_table_size(self, max_serialized_bucket_size: int, bucket_count: int):
        return CuckooTableConfig(
            self.hash_function_count,
            self.max_eviction_count,
            max_serialized_bucket_size,
            CuckooBucketConfig("fixedSize", bucket_count=bucket_count),
            self.multiple_tables,
            self.slot_count,
        )


def default_max_serialized_bucket_size(max_value_size: int, bytes_per_plaintext: int) -> int:
    """CuckooTableConfig.defaultMaxSerializedBucketSize (CuckooTable.swift:109-120)."""
    single = hash_bucket_single_size(max_value_size)
    if single >= bytes_per_plaintext // 2:
        return -(-single // bytes_per_plaintext) * bytes_per_plaintext
    return bytes_per_plaintext // 2


class CuckooTable:
    def __init__(self, config: CuckooTableConfig, database, rng: random.Random | None = None, on_event=None):
        """database: iterable of (keyword bytes, value bytes). on_event, if
        given, receives observability events as (kind, detail) tuples:
        ("createdTable", bucket_count), ("expandedTable", new_bucket_count),
        ("insertedEntry", entry_count so far) every 10% of the database,
        the analogue of CuckooTable.Event (CuckooTable.swift:285-293)."""
        self.config = config
        self.rng = rng or random.Random()
        self.on_event = on_event
        database = list(database)
        self.table_count = config.hash_function_count if config.multiple_tables else 1
        if config.bucket_count.kind == "allowExpansion":
            min_size = hash_bucket_size(len(v) for _, v in database)
            min_buckets = -(-min_size // config.max_serialized_bucket_size)
            target = math.ceil(min_buckets / config.bucket_count.target_load_factor)
            target = -(-target // self.table_count) * self.table_count
        else:
            target = -(-config.bucket_count.bucket_count // self.table_count) * self.table_count
        self._reset(max(target, self.table_count))
        self._emit("createdTable", len(self.buckets))
        report_every = max(1, len(database) // 10)
        for i, (kw, val) in enumerate(database):
            self.insert(kw, val)
            if (i + 1) % report_every == 0:
                self._emit("insertedEntry", i + 1)

    def _reset(self, bucket_count: int):
        self.buckets: list = [[] for _ in range(bucket_count)]
        self._sizes = [1] * bucket_count  # serialized size of each bucket
        self._where: dict = {}  # stored keyword -> its bucket
        self._candidates: dict = {}  # keyword -> its buckets at this size

    def _emit(self, kind: str, detail):
        if self.on_event is not None:
            self.on_event(kind, detail)

    @property
    def buckets_per_table(self) -> int:
        return len(self.buckets) // self.table_count

    @property
    def entry_count(self) -> int:
        return sum(len(b) for b in self.buckets)

    def _index(self, table_index: int, idx: int) -> int:
        return idx if self.table_count == 1 else table_index * self.buckets_per_table + idx

    def _buckets_of(self, keyword: bytes) -> list:
        """The keyword's candidate buckets as indices into self.buckets."""
        found = self._candidates.get(keyword)
        if found is None:
            indices = hash_indices(keyword, self.buckets_per_table, self.config.hash_function_count)
            found = [self._index(t, idx) for t, idx in enumerate(indices)]
            self._candidates[keyword] = found
        return found

    def insert(self, keyword: bytes, value: bytes):
        if hash_bucket_single_size(len(value)) > self.config.max_serialized_bucket_size:
            raise errors.PirError(f"value of size {len(value)} exceeds maxSerializedBucketSize")
        self._insert_loop(keyword, value, self.config.max_eviction_count)

    def _insert_loop(self, keyword: bytes, value: bytes, remaining: int):
        limit = self.config.max_serialized_bucket_size
        if remaining == 0:
            if self.config.bucket_count.kind == "allowExpansion":
                self._expand()
                self.insert(keyword, value)
                return
            raise errors.PirError("cuckoo table full; enable expansion or grow bucketCount")
        if keyword in self._where:  # already in one of its buckets
            return
        candidates = self._buckets_of(keyword)
        entry = hash_bucket_entry_size(len(value))
        for actual in candidates:  # a free slot?
            if len(self.buckets[actual]) < self.config.slot_count and self._sizes[actual] + entry <= limit:
                self.buckets[actual].append((keyword, value))
                self._sizes[actual] += entry
                self._where[keyword] = actual
                return
        # eviction candidates: slots whose value the new one may replace
        evict = [
            (actual, swap)
            for actual in candidates
            for swap, (_, v) in enumerate(self.buckets[actual])
            if self._sizes[actual] - len(v) + len(value) <= limit
        ]
        if evict:
            bucket_idx, slot_idx = self.rng.choice(evict)
            evicted_kw, evicted_val = self.buckets[bucket_idx][slot_idx]
            self.buckets[bucket_idx][slot_idx] = (keyword, value)
            self._sizes[bucket_idx] += len(value) - len(evicted_val)
            del self._where[evicted_kw]
            self._where[keyword] = bucket_idx
            self._insert_loop(evicted_kw, evicted_val, remaining - 1)
        else:
            self._expand()
            self.insert(keyword, value)

    def _expand(self):
        if self.config.bucket_count.kind != "allowExpansion":
            raise errors.PirError("cannot expand fixed-size cuckoo table")
        old = self.buckets
        count = math.ceil(len(old) * self.config.bucket_count.expansion_factor)
        count = -(-count // self.table_count) * self.table_count
        self._reset(count)
        self._emit("expandedTable", count)
        for bucket in old:
            for kw, val in bucket:
                self.insert(kw, val)

    def serialize_buckets(self) -> list:
        return [HashBucket([(keyword_hash(kw), v) for kw, v in b]).serialize() for b in self.buckets]

    def get(self, keyword: bytes) -> bytes | None:
        indices = hash_indices(keyword, self.buckets_per_table, self.config.hash_function_count)
        for t, idx in enumerate(indices):
            for kw, val in self.buckets[self._index(t, idx)]:
                if kw == keyword:
                    return val
        return None

    def summarize(self):
        entry_counts = [len(b) for b in self.buckets]
        return {
            "entryCount": sum(entry_counts),
            "bucketCount": len(self.buckets),
            "emptyBucketCount": sum(1 for c in entry_counts if c == 0),
            "loadFactor": sum(self._sizes) / (len(self.buckets) * self.config.max_serialized_bucket_size),
        }


# ---------------------------------------------------------------------------
# Sharding (KeywordDatabase.swift:40-268)
# ---------------------------------------------------------------------------


def shard_index_sha256(keyword: bytes, shard_count: int) -> int:
    h = hashlib.sha256(keyword).digest()
    return int.from_bytes(h[:8], "little") % shard_count


@dataclass(frozen=True)
class ShardingFunction:
    kind: str = "sha256"  # 'sha256' | 'doubleMod'
    other_shard_count: int = 0

    def shard_index(self, keyword: bytes, shard_count: int) -> int:
        if self.kind == "sha256":
            return shard_index_sha256(keyword, shard_count)
        return shard_index_sha256(keyword, self.other_shard_count) % shard_count


@dataclass(frozen=True)
class Sharding:
    """shardCount or entryCountPerShard strategy."""

    kind: str  # 'shardCount' | 'entryCountPerShard'
    count: int

    def shard_count(self, entry_count: int) -> int:
        if self.kind == "shardCount":
            return self.count
        return max(1, entry_count // self.count)


def shard_database(rows: dict, sharding: Sharding, fn: ShardingFunction = ShardingFunction()):
    """Split keyword-value pairs into disjoint shards."""
    n = sharding.shard_count(len(rows))
    shards: dict = {}
    for kw, val in rows.items():
        idx = fn.shard_index(kw, n)
        shards.setdefault(idx, {})[kw] = val
    return {str(i): s for i, s in shards.items()}


# ---------------------------------------------------------------------------
# Keyword PIR (KeywordPirProtocol.swift:19-391)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KeywordPirConfig:
    dimension_count: int
    cuckoo_table_config: CuckooTableConfig
    uneven_dimensions: bool = True
    key_compression: ip.PirKeyCompression = ip.PirKeyCompression.NO_COMPRESSION
    use_max_serialized_bucket_size: bool = False
    sharding_function: ShardingFunction = ShardingFunction()

    def __post_init__(self):
        if self.dimension_count not in (1, 2):
            raise errors.PirError("dimensionCount must be 1 or 2")
        if not self.cuckoo_table_config.multiple_tables:
            raise errors.PirError("keyword PIR requires multipleTables cuckoo config")

    @property
    def parameter(self) -> "KeywordPirParameter":
        return KeywordPirParameter(self.cuckoo_table_config.hash_function_count, self.sharding_function)


@dataclass(frozen=True)
class KeywordPirParameter:
    hash_function_count: int
    sharding_function: ShardingFunction = ShardingFunction()


@dataclass
class ProcessedDatabaseWithParameters:
    database: ip.ProcessedDatabase
    pir_parameter: ip.IndexPirParameter
    keyword_pir_parameter: KeywordPirParameter | None = None


def sub_tables(processed: ProcessedDatabaseWithParameters) -> list:
    """One index-PIR database per cuckoo hash function: views of the
    processed tensor, no copy."""
    db = processed.database
    kw = processed.keyword_pir_parameter
    if kw is None:
        return [db]
    sub = db.count // kw.hash_function_count
    return [
        ip.ProcessedDatabase(db.context, db.data[s : s + sub], db.present[s : s + sub])
        for s in range(0, db.count, sub)
    ]


class KeywordPirServer:
    """Serves keyword PIR queries one at a time; one index-PIR sub-table per
    hash function. It is the oracle for serving.BatchedKeywordPirServer."""

    def __init__(self, context, processed: ProcessedDatabaseWithParameters):
        self.context = context
        self.index_server = ip.MulPirServer(processed.pir_parameter, context, sub_tables(processed))

    @classmethod
    def process(cls, database, config: KeywordPirConfig, context, rng: random.Random | None = None,
                on_event=None) -> ProcessedDatabaseWithParameters:
        """database: iterable of (keyword, value) pairs."""
        ct_config = config.cuckoo_table_config
        cuckoo = CuckooTable(ct_config, database, rng=rng, on_event=on_event)
        entry_table = cuckoo.serialize_buckets()
        if config.use_max_serialized_bucket_size:
            max_entry_size = ct_config.max_serialized_bucket_size
        elif ct_config.bucket_count.kind == "allowExpansion":
            if not entry_table:
                raise errors.PirError("empty database")
            max_entry_size = max(len(b) for b in entry_table)
        else:
            max_entry_size = ct_config.max_serialized_bucket_size
        index_config = ip.IndexPirConfig(
            entry_count=cuckoo.buckets_per_table,
            entry_size_in_bytes=max_entry_size,
            dimension_count=config.dimension_count,
            batch_size=ct_config.hash_function_count,
            uneven_dimensions=config.uneven_dimensions,
            key_compression=config.key_compression,
            encoding_entry_size=False,
        )
        parameter = ip.generate_parameter(index_config, context)
        bpt = cuckoo.buckets_per_table
        subs = [
            ip.MulPirServer.process(entry_table[start : start + bpt], context, parameter)
            for start in range(0, len(entry_table), bpt)
        ]
        database = ip.ProcessedDatabase(
            context,
            torch.cat([s.data for s in subs]),
            np.concatenate([s.present for s in subs]),
        )
        return ProcessedDatabaseWithParameters(database, parameter, config.parameter)

    def compute_response(self, query: ip.Query, evaluation_key) -> ip.Response:
        return self.index_server.compute_response(query, evaluation_key)

    @property
    def evaluation_key_config(self):
        return self.index_server.evaluation_key_config


class KeywordPirClient:
    def __init__(self, keyword_parameter: KeywordPirParameter, pir_parameter: ip.IndexPirParameter, context):
        self.keyword_parameter = keyword_parameter
        self.index_client = ip.MulPirClient(pir_parameter, context)

    @property
    def evaluation_key_config(self):
        return self.index_client.evaluation_key_config

    def generate_evaluation_key(self, secret_key, err_rng=None):
        return self.index_client.generate_evaluation_key(secret_key, err_rng)

    def _indices(self, keyword: bytes) -> list:
        return hash_indices(
            keyword, self.index_client.parameter.entry_count, self.keyword_parameter.hash_function_count
        )

    def generate_query(self, keyword: bytes, secret_key) -> ip.Query:
        return self.index_client.generate_query(self._indices(keyword), secret_key)

    def decrypt(self, response: ip.Response, keyword: bytes, secret_key) -> bytes | None:
        indices = self._indices(keyword)
        kw_hash = keyword_hash(keyword)
        for raw in self.index_client.decrypt(response, indices, secret_key):
            try:
                bucket = HashBucket.deserialize(raw)
            except errors.PirError:
                continue
            value = bucket.find(kw_hash)
            if value is not None:
                return value
        return None

    def count_entries_in_response(self, response: ip.Response, secret_key) -> int:
        """Privacy diagnostic (KeywordPirProtocol.swift:376-391)."""
        found = 0
        context = self.index_client.context
        bits = coeffio.floor_log2(context.plaintext_modulus)
        for reply in response.ciphertexts:
            data = b"".join(
                coeffio.coefficients_to_bytes(bfv.decode(context, bfv.decrypt(ct, secret_key)), bits)
                for ct in reply
            )
            offset = 0
            while offset < len(data):
                try:
                    bucket = HashBucket.deserialize(data[offset:])
                except errors.PirError:
                    break
                found += len(bucket.slots)
                offset += bucket.serialized_size()
        return found
