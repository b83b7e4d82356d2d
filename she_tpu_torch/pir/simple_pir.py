"""SimplePIR: LWE-based PIR with client-side precomputation, on torch.

The port of she_tpu/pir/simple_pir.py (reference
Sources/PrivateInformationRetrieval/SimplePir/*.swift), bit for bit: the
same parameters, the same seeded A polynomials, the same draws of the
client's secrets and errors, and the same hint, queries and answers.

The database is a Z_p matrix D [column size, database columns]; the hint
is D * A mod q', with A the negacyclic matrix of the seeded A polynomials;
a query is an LWE encryption mod 2^b of a one-hot column selector; the
answer is D * query mod 2^b; the client removes (hint * s) mod q' and
rounds. q' is the smallest (b + 1)-bit NTT prime of the lattice dimension.

Tensors live on the device that `device.resolve_device` names (the CUDA
card unless the caller passes device="cpu"). Where she_tpu computes on the
host with numpy object arrays, the port computes on that device:

* the hint as sums of negacyclic polynomial products through the NTT
  (`_hint_rows`), which gives the bits of she_tpu's materialized product;
* the noiseless sample A * s as one forward NTT of the secrets, one
  product against all A polynomials in Eval and one inverse NTT;
* the answer (`SimplePirServer.compute_response`) through
  ops/simple_pir_cuda.simple_pir_matmul: the u8 tensor-core kernel on the
  card, its plain version on the CPU.

The port's moduli are below 2^62 and q' has b + 1 bits, so it takes
b <= MAX_CIPHERTEXT_BITS = 61 and raises above that.
"""

from __future__ import annotations

import math
import os
import random as pyrandom
from dataclasses import dataclass

import numpy as np
import torch

from .. import errors
from .. import params as paramsmod
from ..core.context import get_poly_context
from ..device import resolve_device
from ..io import coeffs as ser
from ..ops import modarith as ma
from ..ops import ntt as nttmod
from ..ops import simple_pir_cuda
from ..rng import sampling
from ..rng.ctr_drbg import SystemRng, nist_aes128_ctr
from ..utils import nt

MAX_CIPHERTEXT_BITS = 61  # q' < 2^62, the port's modulus bound
ENTRIES_PER_PASS = 8192  # entries packed on the device at a time
HINT_ELEMENTS_PER_PASS = 1 << 25  # int64 elements of D (padded) in one hint pass


@dataclass(frozen=True)
class SimplePirEncryptionParams:
    """SimplePir.swift:19-92."""

    plaintext_modulus_bits: int
    ciphertext_modulus_bits: int
    lattice_dimension: int
    error_std_dev: float = 3.2
    security_level: paramsmod.SecurityLevel = paramsmod.SecurityLevel.QUANTUM128

    def __post_init__(self):
        if not nt.is_power_of_two(self.lattice_dimension):
            raise errors.HeError("lattice dimension must be a power of two")
        if self.ciphertext_modulus_bits <= self.plaintext_modulus_bits:
            raise errors.HeError("ciphertext modulus must exceed plaintext modulus")
        allowed = paramsmod.max_log2_coefficient_modulus(self.lattice_dimension, self.security_level)
        if self.ciphertext_modulus_bits > allowed:
            raise errors.InsecureEncryptionParameters(
                f"{self.ciphertext_modulus_bits} bits > {allowed} for n={self.lattice_dimension}"
            )

    @property
    def ciphertext_mask(self) -> int:
        return (1 << self.ciphertext_modulus_bits) - 1

    @property
    def delta(self) -> int:
        return 1 << (self.ciphertext_modulus_bits - self.plaintext_modulus_bits)


@dataclass(frozen=True)
class SimplePirParameters:
    """SimplePir.swift:95-166."""

    encryption_params: SimplePirEncryptionParams
    entry_size_in_bytes: int
    entries_per_column: int
    chunks_per_entry: int
    database_columns: int
    seed: bytes

    def __post_init__(self):
        assert self.entries_per_column == 1 or self.chunks_per_entry == 1

    @property
    def entry_size_in_scalar(self) -> int:
        return ser.bytes_to_coefficients_coeff_count(
            self.entry_size_in_bytes, self.encryption_params.plaintext_modulus_bits, decode=False
        )

    @property
    def chunk_size(self) -> int:
        return -(-self.entry_size_in_scalar // self.chunks_per_entry)

    @property
    def column_size(self) -> int:
        if self.chunks_per_entry == 1:
            return self.entries_per_column * self.entry_size_in_scalar
        return self.chunk_size

    @property
    def a_poly_count(self) -> int:
        return -(-self.database_columns // self.encryption_params.lattice_dimension)


def computing_params(
    encryption_params: SimplePirEncryptionParams,
    entry_count: int,
    entry_size_in_bytes: int,
    seed: bytes | None = None,
) -> SimplePirParameters:
    """Square-ish database shaping (SimplePir+Database.swift:208-245). The
    ideal column is capped at the entry size, so entries_per_column is
    always 1 (she_tpu's shaping, followed as it is)."""
    entry_size_in_scalar = ser.bytes_to_coefficients_coeff_count(
        entry_size_in_bytes, encryption_params.plaintext_modulus_bits, decode=False
    )
    database_size = entry_count * entry_size_in_scalar
    ideal_column = int(round(math.sqrt(database_size)))
    if ideal_column > entry_size_in_scalar:
        ideal_column = entry_size_in_scalar
    entries_per_column = max(int(round(ideal_column / entry_size_in_scalar)), 1)
    chunks_per_entry = max(int(entry_size_in_scalar / round(ideal_column)), 1)
    if entries_per_column == 1:
        database_columns = entry_count * chunks_per_entry
    else:
        database_columns = max(-(-entry_count // entries_per_column), 1)
    return SimplePirParameters(
        encryption_params=encryption_params,
        entry_size_in_bytes=entry_size_in_bytes,
        entries_per_column=entries_per_column,
        chunks_per_entry=chunks_per_entry,
        database_columns=database_columns,
        seed=seed if seed is not None else os.urandom(32),
    )


def _reverse_negate(x: torch.Tensor, q) -> torch.Tensor:
    """[..., N] -> y with y[0] = x[0] and y[k] = -x[N - k] mod q for k >= 1:
    x(X) -> x(X^-1) in the negacyclic ring."""
    return torch.cat((x[..., :1], ma.neg_mod(x[..., 1:].flip(-1), q)), dim=-1)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


class SimplePirContext:
    """SimplePirContext.swift:19-93, on `device` (the CUDA card by default)."""

    def __init__(self, params: SimplePirParameters, device=None):
        self.params = params
        ep = params.encryption_params
        b = ep.ciphertext_modulus_bits
        if b > MAX_CIPHERTEXT_BITS:
            raise errors.InvalidEncryptionParameters(
                f"the port takes ciphertext moduli of at most {MAX_CIPHERTEXT_BITS} bits, got {b}"
            )
        self.device = resolve_device(device)
        self.ntt_friendly_mod = nt.generate_primes([b + 1], preferring_small=True, ntt_degree=ep.lattice_dimension)[0]
        self.regular_mod = 1 << b
        self.mask = ep.ciphertext_mask
        self.delta = ep.delta
        bits = 32 if self.ntt_friendly_mod < (1 << 30) else 64
        self.extra_context = get_poly_context(ep.lattice_dimension, (self.ntt_friendly_mod,), bits, self.device)
        self.q = self.extra_context.q_col  # [1, 1], tagged: the modulus argument of ops/modarith

    @property
    def degree(self) -> int:
        return self.extra_context.degree

    def forward_ntt(self, x: torch.Tensor) -> torch.Tensor:
        return nttmod.forward_ntt(x, self.extra_context.ntt_tables)

    def inverse_ntt(self, x: torch.Tensor) -> torch.Tensor:
        return nttmod.inverse_ntt(x, self.extra_context.ntt_tables)

    def generate_a_polynomials(self) -> torch.Tensor:
        """int64 [a_poly_count, 1, N] in Coeff, from the parameters' seed."""
        rng = nist_aes128_ctr(self.params.seed)
        polys = [sampling.sample_uniform(rng, [self.ntt_friendly_mod], self.degree)
                 for _ in range(self.params.a_poly_count)]
        return torch.from_numpy(np.stack(polys)).to(self.device)

    def materialize_a_matrix(self, a_polys: torch.Tensor) -> np.ndarray:
        """A[j, k] = coeff j % N of x^k * p_{j // N} (SimplePir+Database.swift:
        186-205), int64 [database_columns, N] on the host. The port computes
        the hint without it (_hint_rows); the tests compare the two."""
        n, q = self.degree, self.ntt_friendly_mod
        coeffs = a_polys.reshape(-1, n).cpu().numpy()
        r, c = np.arange(n)[:, None], np.arange(n)[None, :]
        block = coeffs[:, (r - c) % n]  # [polys, N, N]: (x^c p)[r] = p[r - c], negated where r < c
        block = np.where(r < c, (q - block) % q, block)
        return block.reshape(-1, n)[: self.params.database_columns]

    def mod_switch(self, x: torch.Tensor) -> torch.Tensor:
        """Divide-and-round q' -> 2^b (Array2d.divideAndRound):
        floor((x * 2^b + floor(q' / 2)) / q') mod 2^b for x in [0, q'),
        exactly in int64. x * 2^b needs bits(q') + b bits, over 63 once
        b > 31, so the division runs as a long division in steps of
        63 - bits(q') bits: each step's dividend r * 2^k + (bits of the
        rounding term) stays below q' * 2^k <= 2^63."""
        q, b = self.ntt_friendly_mod, self.params.encryption_params.ciphertext_modulus_bits
        half = q >> 1  # < 2^b, the low b bits of the dividend
        step = 63 - q.bit_length()
        rem, quot = x, torch.zeros_like(x)
        left = b
        while left > 0:
            k = min(step, left)
            left -= k
            t = rem * (1 << k) + ((half >> left) & ((1 << k) - 1))
            digit = torch.div(t, q, rounding_mode="floor")
            rem = t - digit * q
            quot = quot * (1 << k) + digit
        return quot & (self.regular_mod - 1)

    def generate_secret_polys(self, rng=None) -> torch.Tensor:
        """int64 [chunks_per_entry, 1, N] ternary secrets mod q', in Coeff."""
        rng = rng or SystemRng()
        polys = [sampling.sample_ternary(rng, [self.ntt_friendly_mod], self.degree)
                 for _ in range(self.params.chunks_per_entry)]
        return torch.from_numpy(np.stack(polys)).to(self.device)

    def noiseless_sample(self, a_polys_eval: torch.Tensor, secret_polys: torch.Tensor) -> torch.Tensor:
        """A * s via negacyclic polynomial products (SimplePir+Client.swift:
        20-50): one forward NTT of the secrets, one product with every A
        polynomial in Eval, one inverse NTT of [chunks, a_poly_count, 1, N];
        int64 [chunks, database_columns] in [0, q')."""
        s_eval = self.forward_ntt(secret_polys)
        prod = ma.mul_mod(s_eval[:, None], a_polys_eval[None], self.q)
        coeffs = self.inverse_ntt(prod).reshape(secret_polys.shape[0], -1)
        return coeffs[:, : self.params.database_columns]

    def encrypt_zero(self, a_polys_eval, secret_polys, rng=None) -> torch.Tensor:
        """(A * s mod-switched) + CBD error mod 2^b (SimplePir+Client.swift:55-80)."""
        rng = rng or SystemRng()
        p = self.params
        sample = self.mod_switch(self.noiseless_sample(a_polys_eval, secret_polys))
        err = sampling.sample_centered_binomial(
            rng, [self.regular_mod], p.database_columns * p.chunks_per_entry,
            p.encryption_params.error_std_dev,
        )[0].reshape(p.chunks_per_entry, p.database_columns)
        return (sample + torch.from_numpy(err).to(self.device)) & (self.regular_mod - 1)

    def extract_entries(self, data: torch.Tensor, index: int) -> torch.Tensor:
        """[chunks, columnSize] -> [chunks, chunkSize] for an entry index."""
        p = self.params
        out = []
        for qi in range(p.chunks_per_entry):
            entry_index = index * p.chunks_per_entry + qi
            start = (entry_index % p.entries_per_column) * p.chunk_size
            out.append(data[qi, start : start + p.chunk_size])
        return torch.stack(out)


# ---------------------------------------------------------------------------
# Database processing
# ---------------------------------------------------------------------------


@dataclass
class SimplePirProcessResults:
    database: torch.Tensor  # [columnSize, databaseColumns] entries mod 2^p (int16/32/64)
    hint: torch.Tensor  # int64 [columnSize, latticeDimension] mod q'
    params: SimplePirParameters


def database_dtype(plaintext_bits: int) -> torch.dtype:
    """The narrowest signed integer type that holds entries below 2^p."""
    return torch.int16 if plaintext_bits <= 15 else torch.int32 if plaintext_bits <= 31 else torch.int64


def _entry_rows(entries, start: int, stop: int, entry_size: int) -> np.ndarray:
    """uint8 [stop - start, entry_size]: entries [start, stop), each padded
    with zero bytes to entry_size."""
    if isinstance(entries, np.ndarray):
        return entries[start:stop]
    out = np.zeros((stop - start, entry_size), dtype=np.uint8)
    for i, e in enumerate(entries[start:stop]):
        out[i, : len(e)] = np.frombuffer(bytes(e), dtype=np.uint8)
    return out


def _hint_rows(database: torch.Tensor, a_polys_eval: torch.Tensor, ctx: SimplePirContext) -> torch.Tensor:
    """hint = (D @ A) mod q', int64 [rows, N], without A.

    she_tpu materializes A (materialize_a_matrix) and multiplies D by it on
    the host; this computes the same bits as polynomial products. Block b
    of A is the negacyclic matrix of p_b: A[bN + j, k] = (x^k p_b)[j]. So
    for row r, with d_b its N entries of block b (zero past the database
    columns) and d~_b(x) = d_b(x^-1) = d_b[0] - sum_{j>=1} d_b[j] x^(N-j),
    f = sum_b d~_b * p_b in Z_q'[x]/(x^N + 1) gives hint[r, 0] = f[0] and
    hint[r, k] = -f[N - k] for k >= 1: hint[r] = f(x^-1). Per pass of rows:
    one forward NTT of [rows, a_poly_count, 1, N], the product with the A
    polynomials in Eval summed over b, one inverse NTT of [rows, 1, N]."""
    rows, cols = database.shape
    n, blocks = ctx.degree, ctx.params.a_poly_count
    per_pass = max(1, HINT_ELEMENTS_PER_PASS // (blocks * n))
    hint = torch.empty((rows, n), dtype=torch.int64, device=database.device)
    for r0 in range(0, rows, per_pass):
        d = database[r0 : r0 + per_pass].to(torch.int64)
        d = torch.nn.functional.pad(d, (0, blocks * n - cols)).reshape(-1, blocks, 1, n)
        d_eval = ctx.forward_ntt(_reverse_negate(d, ctx.q))
        f_eval = ma.sum_mod(ma.mul_mod(d_eval, a_polys_eval, ctx.q), ctx.q, dim=1)
        hint[r0 : r0 + d.shape[0]] = _reverse_negate(ctx.inverse_ntt(f_eval), ctx.q)[:, 0]
    return hint


def process_database(entries, encryption_params: SimplePirEncryptionParams, seed: bytes | None = None,
                     device=None, on_stage=None) -> SimplePirProcessResults:
    """SimplePir+Database.swift:247-291, on `device` (the CUDA card by
    default). `entries` is a list of byte strings (padded with zero bytes
    to the longest) or a uint8 array [entry_count, entry_size]. Entries
    are packed ENTRIES_PER_PASS at a time, on the device (io/coeffs
    unpack_fields; on the host above its 57 bits), into the database
    [column size, database columns]; the hint goes through the NTT
    (_hint_rows). `on_stage`, if given, is called with "pack" once the
    database's packing is issued and with "hint" once the hint's is."""
    dev = resolve_device(device)
    if isinstance(entries, np.ndarray):
        if entries.ndim != 2 or entries.dtype != np.uint8:
            raise errors.PirError(f"entries must be uint8 [count, size], got {entries.dtype} {entries.shape}")
        entry_count, entry_size = entries.shape
    else:
        entry_count, entry_size = len(entries), max((len(e) for e in entries), default=0)
    params = computing_params(encryption_params, entry_count, entry_size, seed)
    p_bits = encryption_params.plaintext_modulus_bits
    if params.entries_per_column != 1:  # computing_params caps the column at one entry
        raise errors.PirError("entries_per_column > 1 is not produced by computing_params")
    chunks = params.chunks_per_entry
    column_size = params.column_size
    database = torch.zeros((column_size, params.database_columns), dtype=database_dtype(p_bits), device=dev)
    for start in range(0, entry_count, ENTRIES_PER_PASS):
        stop = min(start + ENTRIES_PER_PASS, entry_count)
        rows = np.array(_entry_rows(entries, start, stop, entry_size), dtype=np.uint8)  # a writable copy
        if p_bits <= ser.WINDOW_MAX_BITS:
            coeffs = ser.unpack_fields(torch.from_numpy(rows).to(dev), p_bits, params.entry_size_in_scalar)
        else:
            coeffs = torch.from_numpy(ser.bytes_to_coefficients_rows(rows, p_bits, decode=False)).to(dev)
        coeffs = torch.nn.functional.pad(coeffs, (0, chunks * column_size - coeffs.shape[1]))
        # entry i's padded coefficients are its chunks' columns i * chunks, ...
        database[:, start * chunks : stop * chunks] = coeffs.reshape(-1, column_size).T.to(database.dtype)
    if on_stage is not None:
        on_stage("pack")
    ctx = SimplePirContext(params, dev)
    hint = _hint_rows(database, ctx.forward_ntt(ctx.generate_a_polynomials()), ctx)
    if on_stage is not None:
        on_stage("hint")
    return SimplePirProcessResults(database, hint, params)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class SimplePirServer:
    """Answers with D @ requests^T mod 2^b (SimplePir+Server.swift:20-39).
    The database's byte planes are made once, here, on `device` (the CUDA
    card by default), and are all the server keeps of the database."""

    def __init__(self, database, hint, params: SimplePirParameters, device=None):
        # `hint` is taken for she_tpu's signature; only the client uses it.
        self.params = params
        self.planes = simple_pir_cuda.database_planes(
            _as_tensor(database, resolve_device(device)), params.encryption_params.plaintext_modulus_bits
        )

    def compute_response(self, requests) -> torch.Tensor:
        """requests [k, databaseColumns] (one query's chunks, or the request
        rows of many queries stacked) -> int64 [k, columnSize] mod 2^b."""
        requests = _as_tensor(requests, self.planes.data.device)
        return simple_pir_cuda.simple_pir_matmul(
            self.planes, requests, self.params.encryption_params.ciphertext_modulus_bits
        )


# ---------------------------------------------------------------------------
# Client (precomputed query pipeline, SimplePir+Precompute.swift:191-315)
# ---------------------------------------------------------------------------


@dataclass
class PrecomputedQueryWithoutIndices:
    context: SimplePirContext
    queries_without_indices: torch.Tensor  # [chunks, cols] mod 2^b
    results_without_response: torch.Tensor  # [chunks, columnSize] mod q'

    def add(self, index: int) -> "PrecomputedQueryWithIndices":
        p = self.context.params
        queries = self.queries_without_indices.clone()
        for qi in range(p.chunks_per_entry):
            col = (index * p.chunks_per_entry + qi) // p.entries_per_column
            queries[qi, col] = (queries[qi, col] + self.context.delta) & self.context.mask
        return PrecomputedQueryWithIndices(self.context, queries, self.results_without_response, index)


@dataclass
class PrecomputedQueryWithIndices:
    context: SimplePirContext
    queries: torch.Tensor
    results_without_response: torch.Tensor
    index: int

    def prepare_response(self) -> "PreparedResponse":
        return PreparedResponse(
            self.context, self.context.extract_entries(self.results_without_response, self.index)
        )


@dataclass
class PreparedResponse:
    context: SimplePirContext
    results_without_response: torch.Tensor

    def integrate(self, responses: torch.Tensor, index: int) -> list[int]:
        ctx = self.context
        b = ctx.params.encryption_params.ciphertext_modulus_bits
        p = ctx.params.encryption_params.plaintext_modulus_bits
        extracted = ctx.extract_entries(_as_tensor(responses, ctx.device), index)
        out = torch.remainder(extracted - self.results_without_response + (ctx.delta >> 1), 1 << b)
        return (out >> (b - p)).reshape(-1).cpu().tolist()


# ---------------------------------------------------------------------------
# Multi-shard layout (DatabaseMap.swift:23-110, SimplePir+Shards.swift:18-188)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChunkLocation:
    shard_index: int
    index: int


@dataclass(frozen=True)
class DatabaseMapEntry:
    original_index: int
    size: int
    chunks: tuple


@dataclass(frozen=True)
class DatabaseMap:
    """Tracks where each entry's chunks landed across shards."""

    entries: tuple
    chunk_size: int

    @staticmethod
    def shard_database(entries, shard_count: int, chunk_size: int, rng=None):
        """entries: iterable of (original_index, value bytes). Chunks are
        spread over a per-entry random shard permutation; returns
        (DatabaseMap, [shard byte-matrices as list[bytes]])."""
        rng = rng or pyrandom.Random()
        out_entries = []
        shards: list[list[bytes]] = [[] for _ in range(shard_count)]
        for original_index, value in entries:
            chunks = []
            order = list(range(shard_count))
            rng.shuffle(order)
            v = bytes(value)
            n_chunks = max(1, -(-len(v) // chunk_size)) if v else 1
            for ci in range(n_chunks):
                chunk = v[ci * chunk_size : (ci + 1) * chunk_size]
                chunk = chunk + b"\x00" * (chunk_size - len(chunk))
                shard_index = order[ci % shard_count]
                chunks.append(ChunkLocation(shard_index, len(shards[shard_index])))
                shards[shard_index].append(chunk)
            out_entries.append(DatabaseMapEntry(original_index, len(v), tuple(chunks)))
        return DatabaseMap(tuple(out_entries), chunk_size), shards


class ShardMap:
    """original index -> entry lookup + per-shard query budget."""

    def __init__(self, database_map: DatabaseMap):
        self.mapping = {e.original_index: e for e in database_map.entries}
        shard_ids = {c.shard_index for e in self.mapping.values() for c in e.chunks}
        self.shard_count = len(shard_ids)
        self.maximum_chunk_count = max((len(e.chunks) for e in self.mapping.values()), default=0)
        self.chunk_size = database_map.chunk_size
        self.chunks_per_shard = -(-self.maximum_chunk_count // max(self.shard_count, 1))

    def __getitem__(self, original_index: int):
        return self.mapping.get(original_index)


class SimplePirClientForAllShards:
    """Queries every shard (with dummy index-0 queries for padding) so the
    access pattern does not leak which shards hold the entry."""

    def __init__(self, database_map: DatabaseMap, clients: list):
        self.shard_map = ShardMap(database_map)
        self.clients = clients
        if self.shard_map.shard_count > len(clients):
            raise errors.PirError("mismatching shard count and clients")

    @property
    def queries_per_shard(self) -> int:
        return self.shard_map.chunks_per_shard

    def query(self, original_index: int, rng=None):
        query_indices = [[] for _ in self.clients]
        entry = self.shard_map[original_index]
        if entry is not None:
            for chunk in entry.chunks:
                query_indices[chunk.shard_index].append(chunk.index)
        for per_shard in query_indices:
            while len(per_shard) < self.shard_map.chunks_per_shard:
                per_shard.append(0)
        return [
            [client.query(i, rng=rng) for i in indices]
            for client, indices in zip(self.clients, query_indices)
        ]

    def decrypt(self, responses, original_index: int, queries) -> bytes | None:
        entry = self.shard_map[original_index]
        if entry is None:
            return None
        data = b""
        for chunk in entry.chunks:
            shard = chunk.shard_index
            slot = [i for i, q in enumerate(queries[shard]) if q.index == chunk.index][0]
            prepared = queries[shard][slot].prepare_response()
            piece = self.clients[shard].decrypt(responses[shard][slot], prepared, chunk.index)
            data += piece[: self.shard_map.chunk_size]
        return data[: entry.size]


class SimplePirClient:
    """SimplePir+Client.swift, on `device` (the CUDA card by default): the
    A polynomials are drawn from the seed and taken to Eval once."""

    def __init__(self, params: SimplePirParameters, hint, device=None):
        self.context = SimplePirContext(params, device)
        self.hint = _as_tensor(hint, self.context.device)
        self._a_polys_eval = self.context.forward_ntt(self.context.generate_a_polynomials())

    def precompute_query(self, rng=None) -> PrecomputedQueryWithoutIndices:
        """The secrets, the encrypted zero, and (s . hint^T) mod q' per chunk
        (exact modular products summed over N, at any width of q')."""
        ctx = self.context
        secret_polys = ctx.generate_secret_polys(rng)
        queries = ctx.encrypt_zero(self._a_polys_eval, secret_polys, rng)
        products = ma.mul_mod(self.hint[None], secret_polys, ctx.q)  # [chunks, columnSize, N]
        return PrecomputedQueryWithoutIndices(ctx, queries, ma.sum_mod(products, ctx.q, dim=-1))

    def query(self, index: int, rng=None) -> PrecomputedQueryWithIndices:
        return self.precompute_query(rng).add(index)

    def decrypt(self, responses, prepared: PreparedResponse, index: int) -> bytes:
        coeffs = prepared.integrate(responses, index)
        data = ser.coefficients_to_bytes(coeffs, self.context.params.encryption_params.plaintext_modulus_bits)
        return bytes(data[: self.context.params.entry_size_in_bytes])
