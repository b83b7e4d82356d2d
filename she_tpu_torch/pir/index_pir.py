"""Index PIR: MulPIR (eprint 2019/1483) over the port's BFV core.

The port of she_tpu/pir/index_pir.py (reference Sources/
PrivateInformationRetrieval/IndexPir/{IndexPirProtocol,MulPir,PirUtil}.swift):
config and parameter generation, the oblivious expansion (she_tpu's
node-by-node expand_ciphertext, and expand, which serves level by level
through pir/expansion.py), query compression, the client, the per-query
server (the reference the batched server is checked against) and database
processing.

A processed database is one dense Eval tensor [count, L, N] plus a mask of
the plaintexts that are present (a zero plaintext is skipped, as she_tpu's
None entries are); database processing packs all entries with numpy and
encodes every plaintext with one batched NTT.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from .. import errors
from ..bfv import bfv, keys
from ..core.poly import COEFF, EVAL, PolyRq
from ..io import coeffs as coeffio
from ..utils import nt
from .expansion import expand_batched, expansion_step_element


class PirKeyCompression(Enum):
    NO_COMPRESSION = "noCompression"
    HYBRID = "hybridCompression"
    MAX = "maxCompression"


def entry_size_encoding_width(entry_size: int) -> int:
    if entry_size <= 0xFF:
        return 1
    if entry_size <= 0xFFFF:
        return 2
    if entry_size <= 0xFFFFFFFF:
        return 4
    return 8


def decode_entry_size(data: bytes) -> int:
    return int.from_bytes(data, "little")


@dataclass(frozen=True)
class IndexPirConfig:
    """Reference IndexPirProtocol.swift:44-157."""

    entry_count: int
    entry_size_in_bytes: int
    dimension_count: int = 2
    batch_size: int = 1
    uneven_dimensions: bool = True
    key_compression: PirKeyCompression = PirKeyCompression.NO_COMPRESSION
    encoding_entry_size: bool = False

    def __post_init__(self):
        if self.dimension_count not in (1, 2):
            raise errors.PirError(f"dimensionCount must be 1 or 2, got {self.dimension_count}")

    @property
    def entry_size_encoding_width(self) -> int:
        return entry_size_encoding_width(self.entry_size_in_bytes) if self.encoding_entry_size else 0

    @property
    def encoded_entry_size(self) -> int:
        return self.entry_size_encoding_width + self.entry_size_in_bytes


@dataclass(frozen=True)
class IndexPirParameter:
    entry_count: int
    entry_size_in_bytes: int
    dimensions: tuple[int, ...]
    batch_size: int
    evaluation_key_config: keys.EvaluationKeyConfig
    encoding_entry_size: bool = False

    @property
    def entry_size_encoding_width(self) -> int:
        return entry_size_encoding_width(self.entry_size_in_bytes) if self.encoding_entry_size else 0

    @property
    def encoded_entry_size(self) -> int:
        return self.entry_size_encoding_width + self.entry_size_in_bytes

    @property
    def expanded_query_count(self) -> int:
        return sum(self.dimensions)


@dataclass
class Query:
    ciphertexts: list
    indices_count: int


@dataclass
class Response:
    ciphertexts: list  # [[Ciphertext Coeff]]: per query index, per chunk


@dataclass
class ProcessedDatabase:
    """Eval plaintexts as one tensor [count, L, N] over the ciphertext
    moduli; present[i] is False for a skipped zero plaintext, whose row is
    all zeros (IndexPirProtocol.swift:249-379)."""

    context: bfv.BfvContext
    data: torch.Tensor
    present: np.ndarray

    @property
    def count(self) -> int:
        return self.data.shape[0]

    @property
    def plaintexts(self) -> list:
        """Per-plaintext view: an Eval Plaintext, or None where skipped."""
        ctx = self.context.ciphertext_context
        return [
            bfv.Plaintext(self.context, PolyRq(self.data[i], ctx, EVAL)) if self.present[i] else None
            for i in range(self.count)
        ]

    SERIALIZATION_VERSION = 1

    def serialize(self) -> bytes:
        """she_tpu's v1 bytes: version, u32-LE count, then per plaintext a
        tag (0 skipped, 1 present) and the present plaintext's packed rows
        (IndexPirProtocol.swift:249-379). Rows are packed per modulus in one
        numpy pass."""
        ctx = self.context.ciphertext_context
        present = np.flatnonzero(self.present)
        vals = self.data[torch.from_numpy(present).to(self.data.device)].cpu().numpy()
        body = np.concatenate(
            [coeffio.coefficients_to_bytes_rows(vals[:, i], coeffio.ceil_log2(q)) for i, q in enumerate(ctx.moduli)],
            axis=1,
        )
        out = [bytes([self.SERIALIZATION_VERSION]), self.count.to_bytes(4, "little")]
        rows = iter(body)
        for p in self.present:
            out.append(b"\x01" + next(rows).tobytes() if p else b"\x00")
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes, context) -> "ProcessedDatabase":
        if data[0] != cls.SERIALIZATION_VERSION:
            raise errors.PirError(f"bad serialization version {data[0]}")
        count = int.from_bytes(data[1:5], "little")
        ctx = context.ciphertext_context
        widths = [coeffio.coefficients_to_bytes_byte_count(ctx.degree, coeffio.ceil_log2(q)) for q in ctx.moduli]
        nbytes = sum(widths)
        present = np.zeros(count, dtype=bool)
        starts = []
        offset = 5
        for i in range(count):
            tag = data[offset]
            offset += 1
            if tag == 1:
                present[i] = True
                starts.append(offset)
                offset += nbytes
            elif tag != 0:
                raise errors.PirError(f"bad plaintext tag {tag}")
        buf = np.frombuffer(data, dtype=np.uint8)
        if offset > buf.size:
            raise errors.SerializationError("buffer too short for processed database")
        body = buf[np.asarray(starts, dtype=np.int64)[:, None] + np.arange(nbytes)]
        vals = np.zeros((count, len(ctx.moduli), ctx.degree), dtype=np.int64)
        col = 0
        for i, (q, w) in enumerate(zip(ctx.moduli, widths)):
            coeffs = coeffio.bytes_to_coefficients_rows(body[:, col : col + w], coeffio.ceil_log2(q), decode=False)
            vals[present, i] = coeffs[:, : ctx.degree]
            col += w
        return cls(context, torch.from_numpy(vals).to(context.device), present)


# ---------------------------------------------------------------------------
# MulPIR parameter generation
# ---------------------------------------------------------------------------


def evaluation_key_config(
    expanded_query_count: int, degree: int, key_compression: PirKeyCompression
) -> keys.EvaluationKeyConfig:
    """Galois elements {2^l + 1} for the expansion depth; the compressed
    variants take every other power (reference MulPir.swift:86-109)."""
    max_depth = coeffio.ceil_log2(min(expanded_query_count, degree))
    log2n = nt.log2_exact(degree)
    smallest = log2n - max_depth + 1
    if key_compression == PirKeyCompression.NO_COMPRESSION:
        largest = log2n
    else:
        largest = max(smallest, -(-(log2n + 1) // 2))
    elements = [(1 << level) + 1 for level in range(smallest, largest + 1)]
    if key_compression == PirKeyCompression.HYBRID:
        extra_power = max(largest, (log2n + largest + 1) // 2)
        extra = (1 << extra_power) + 1
        if extra not in elements:
            elements.append(extra)
    return keys.EvaluationKeyConfig(tuple(elements), has_relinearization_key=True)


def generate_parameter(config: IndexPirConfig, context: bfv.BfvContext) -> IndexPirParameter:
    """Reference MulPir.swift:37-83 (incl. the uneven-dimensions optimization)."""
    encoded_entry_size = config.encoded_entry_size
    bpp = context.params.bytes_per_plaintext
    if encoded_entry_size <= bpp:
        per_chunk = -(-config.entry_count // (bpp // encoded_entry_size))
    else:
        per_chunk = config.entry_count
    dim_size = int(math.floor(per_chunk ** (1.0 / config.dimension_count)))
    dims = [dim_size] * config.dimension_count
    for i in range(len(dims)):
        if math.prod(dims) < per_chunk:
            dims[i] += 1
        else:
            break
    if config.uneven_dimensions and config.dimension_count == 2:
        limit = nt.next_power_of_two(sum(dims) * config.batch_size)
        new_dims = list(dims)
        while nt.next_power_of_two(sum(new_dims) * config.batch_size) <= limit:
            dims = list(new_dims)
            if new_dims[1] == 1:
                break
            new_dims[1] -= 1
            new_dims[0] = -(-per_chunk // new_dims[1])
    ek_config = evaluation_key_config(
        sum(dims) * config.batch_size, context.degree, config.key_compression
    )
    return IndexPirParameter(
        entry_count=config.entry_count,
        entry_size_in_bytes=config.entry_size_in_bytes,
        dimensions=tuple(dims),
        batch_size=config.batch_size,
        evaluation_key_config=ek_config,
        encoding_entry_size=config.encoding_entry_size,
    )


def per_chunk_plaintext_count(parameter: IndexPirParameter) -> int:
    return math.prod(parameter.dimensions)


def chunk_count(parameter: IndexPirParameter, context: bfv.BfvContext) -> int:
    return -(-parameter.encoded_entry_size // context.params.bytes_per_plaintext)


# ---------------------------------------------------------------------------
# Oblivious expansion (PirUtil.swift:190-355)
# ---------------------------------------------------------------------------


def expand_ciphertext_for_one_step(ct, log_step: int, evaluation_key):
    """One expansion step: (ct + g(ct), x^{-2^(logStep-1)} * (ct - g(ct)))."""
    element, apply_count = expansion_step_element(evaluation_key, ct.context.degree, log_step)
    c1 = ct
    for _ in range(apply_count):
        c1 = bfv.apply_galois(c1, element, evaluation_key)
    difference = bfv.multiply_power_of_x(bfv.ct_sub(ct, c1), -(1 << (log_step - 1)))
    return bfv.ct_add(c1, ct), difference


def expand_ciphertext(ct, output_count: int, log_step: int, expected_height: int, evaluation_key):
    """Binary-tree expansion with doubling-factor correction
    (PirUtil.swift:249-304)."""
    if not 0 <= output_count <= ct.context.degree:
        raise errors.PirError(f"output count {output_count} out of range")
    if output_count == 1:
        if log_step > expected_height:
            return [ct]
        return [bfv.ct_add(ct, ct)]
    second_half = output_count >> 1
    first_half = output_count - second_half
    p0, p1 = expand_ciphertext_for_one_step(ct, log_step, evaluation_key)
    first = expand_ciphertext(p0, first_half, log_step + 1, expected_height, evaluation_key)
    second = expand_ciphertext(p1, second_half, log_step + 1, expected_height, evaluation_key)
    out = []
    for a, b in zip(first[:second_half], second):
        out.extend([a, b])
    out.extend(first[second_half:])
    return out


def expand(ciphertexts: list, output_count: int, evaluation_key) -> list:
    """Each ciphertext expanded into its min(remaining, N) outputs
    (PirUtil.swift:306-355), level by level: expansion.expand_batched at a
    batch of one, a key switch and one expand_combine a level, each
    parent read in place from the pool (on a CUDA card, the kernels of
    csrc/key_switch.cu). The same tree, doubling and bits as
    expand_ciphertext, she_tpu's node by node structure, which stays as
    the reference."""
    degree = ciphertexts[0].context.degree
    if not (len(ciphertexts) - 1) * degree < output_count <= len(ciphertexts) * degree:
        raise errors.PirError(f"{len(ciphertexts)} ciphertexts cannot expand to {output_count}")
    first = ciphertexts[0]
    for i, ct in enumerate(ciphertexts):
        if output_count - degree * i > 1:  # apply_galois's checks, as she_tpu's first step makes them
            if len(ct.polys) != 2:
                raise errors.InvalidCiphertext("applyGalois requires 2 polys")
            if ct.correction_factor != 1:
                raise errors.InvalidCorrectionFactor(str(ct.correction_factor))
            if ct.fmt != COEFF:
                raise errors.InvalidFormat("applyGalois requires canonical (Coeff) format")
    stacked = [bfv.stacked_view(ct).unsqueeze(0) for ct in ciphertexts]
    out = expand_batched(stacked, output_count, evaluation_key, first.context)
    return [bfv.Ciphertext.from_stacked(first.context, o[0], first.poly_context(), first.fmt, first.correction_factor)
            for o in out.unbind(0)]


def compress_binary_inputs(total_input_count: int, one_indices: list[int], context, secret_key) -> list:
    """Client-side query compression: 2^{-ceillog(count)} at the chosen slots
    (PirUtil.swift:361-404)."""
    t = context.plaintext_modulus
    out = []
    processed = 0
    remaining = total_input_count
    while remaining > 0:
        n = min(remaining, context.degree)
        inputs = [x - processed for x in one_indices if processed <= x < processed + n]
        inv = nt.inverse_mod(pow(2, coeffio.ceil_log2(n), t), t)
        raw = [0] * context.degree
        for idx in inputs:
            raw[idx] = inv
        out.append(bfv.encode(context, raw))
        processed += n
        remaining -= n
    return [bfv.encrypt(pt, secret_key) for pt in out]


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class MulPirClient:
    def __init__(self, parameter: IndexPirParameter, context: bfv.BfvContext):
        self.parameter = parameter
        self.context = context

    @property
    def evaluation_key_config(self):
        return self.parameter.evaluation_key_config

    @property
    def entry_chunks_per_plaintext(self) -> int:
        bpp = self.context.params.bytes_per_plaintext
        if bpp >= self.parameter.encoded_entry_size:
            return bpp // self.parameter.encoded_entry_size
        return 1

    def generate_evaluation_key(self, secret_key, err_rng=None):
        return keys.generate_evaluation_key(
            self.context, self.evaluation_key_config, secret_key, err_rng
        )

    def compute_coordinates(self, index: int) -> list[int]:
        if not 0 <= index < self.parameter.entry_count:
            raise errors.PirError(f"invalid index {index}")
        pt_index = index // self.entry_chunks_per_plaintext
        product = math.prod(self.parameter.dimensions)
        coords = []
        for dim in self.parameter.dimensions:
            product //= dim
            coords.append(pt_index // product)
            pt_index -= coords[-1] * product
        return coords

    def generate_query(self, indices: list[int], secret_key) -> Query:
        acc = 0
        one_indices = []
        for index in indices:
            coords = self.compute_coordinates(index)
            for dim_index, dim_size in enumerate(self.parameter.dimensions):
                one_indices.append(acc + coords[dim_index])
                acc += dim_size
        cts = compress_binary_inputs(
            self.parameter.expanded_query_count * len(indices),
            one_indices,
            self.context,
            secret_key,
        )
        return Query(cts, len(indices))

    @property
    def expected_response_ciphertext_count(self) -> int:
        return chunk_count(self.parameter, self.context)

    def decrypt(self, response: Response, indices: list[int], secret_key) -> list[bytes]:
        if len(response.ciphertexts) != len(indices):
            raise errors.PirError("response count mismatch")
        bits = coeffio.floor_log2(self.context.plaintext_modulus)
        out = []
        for reply, entry_index in zip(response.ciphertexts, indices):
            if len(reply) != self.expected_response_ciphertext_count:
                raise errors.PirError("reply chunk count mismatch")
            data = b""
            for ct in reply:
                pt = bfv.decrypt(ct, secret_key)
                data += coeffio.coefficients_to_bytes(bfv.decode(self.context, pt), bits)
            pos = entry_index % self.entry_chunks_per_plaintext
            size = self.parameter.encoded_entry_size
            chunk = data[pos * size : (pos + 1) * size]
            if self.parameter.encoding_entry_size:
                w = self.parameter.entry_size_encoding_width
                entry_size = decode_entry_size(chunk[:w])
                out.append(chunk[w : w + entry_size])
            else:
                out.append(chunk)
        return out


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class MulPirServer:
    """The per-query server: one query at a time, list by list, as the
    reference computes it. It is the oracle for BatchedMulPirServer."""

    def __init__(self, parameter: IndexPirParameter, context: bfv.BfvContext, databases: list):
        self.parameter = parameter
        self.context = context
        self.databases = databases
        expected = chunk_count(parameter, context) * per_chunk_plaintext_count(parameter)
        for db in databases:
            if db.count != expected:
                raise errors.PirError(f"database has {db.count} plaintexts, expected {expected}")

    @property
    def evaluation_key_config(self):
        return self.parameter.evaluation_key_config

    def compute_response_for_one_chunk(self, dim0_query_eval, remaining_query, data_chunk, evaluation_key):
        """PirUtil.swift:408-486."""
        parameter = self.parameter
        columns = per_chunk_plaintext_count(parameter) // parameter.dimensions[0]
        if columns not in (1, len(remaining_query)):
            raise errors.PirError("dimension mismatch")
        results = []
        for col in range(columns):
            start = len(dim0_query_eval) * col
            end = min(start + len(dim0_query_eval), len(data_chunk))
            pts = list(data_chunk[start:end])
            if all(p is None for p in pts):
                # zero column: an inner product of nothing is a transparent zero
                ctx = dim0_query_eval[0].polys[0].context
                results.append(bfv.Ciphertext(self.context, [PolyRq.zero(ctx, COEFF) for _ in range(2)]))
                continue
            acc = bfv.inner_product_ct_pt(dim0_query_eval, pts)
            results.append(bfv.ct_to_coeff(acc))
        query_start = 0
        for dim_size in parameter.dimensions[1:]:
            new_results = []
            for start in range(0, len(results), dim_size):
                v0 = remaining_query[query_start : query_start + dim_size]
                v1 = results[start : start + dim_size]
                prod = bfv.inner_product_ct_ct(v0, v1)
                new_results.append(bfv.relinearize(prod, evaluation_key))
            results = new_results
            query_start += dim_size
        if len(results) != 1:
            raise errors.PirError("dimensions do not reduce to one ciphertext")
        return bfv.ct_to_coeff(bfv.mod_switch_down_to_single(results[0]))

    def compute_response(self, query: Query, evaluation_key) -> Response:
        """PirUtil.swift:490-568."""
        parameter = self.parameter
        if len(self.databases) != 1 and len(self.databases) < query.indices_count:
            raise errors.PirError("invalid batch size")
        expanded = expand(
            query.ciphertexts, parameter.expanded_query_count * query.indices_count, evaluation_key
        )
        n_chunks = chunk_count(parameter, self.context)
        per_query = parameter.expanded_query_count
        responses = []
        for q in range(query.indices_count):
            db = self.databases[0 if len(self.databases) == 1 else q]
            q_cts = expanded[q * per_query : (q + 1) * per_query]
            dim0 = [bfv.ct_to_eval(c) for c in q_cts[: parameter.dimensions[0]]]
            rest = q_cts[parameter.dimensions[0] :]
            per_chunk = db.count // n_chunks
            plaintexts = db.plaintexts
            reply = [
                self.compute_response_for_one_chunk(
                    dim0, rest, plaintexts[start : start + per_chunk], evaluation_key
                )
                for start in range(0, db.count, per_chunk)
            ]
            responses.append(reply)
        return Response(responses)

    # -- database processing (MulPir.swift:430-556) -----------------------

    @classmethod
    def process(cls, database, context: bfv.BfvContext, parameter: IndexPirParameter) -> ProcessedDatabase:
        """database: a list of `bytes` entries, or a uint8 array
        [entry_count, entry_size] of equal-size entries. Entries are packed
        with numpy and all plaintexts are encoded with one batched NTT.

        An entry that fits a plaintext shares it with its neighbours
        (MulPir.swift _processPackEntries); a larger one is split into
        chunk_count plaintext-sized pieces, and the database is stored
        chunk-major, chunk k's plaintexts after chunk k-1's
        (she_tpu's _process_split_large_entries). A plaintext of zeros is
        marked not present."""
        if len(database) != parameter.entry_count:
            raise errors.PirError(f"{len(database)} entries, expected {parameter.entry_count}")
        entries = _encoded_entries(database, parameter)
        bpp = context.params.bytes_per_plaintext
        n_chunks = chunk_count(parameter, context)
        per_chunk = per_chunk_plaintext_count(parameter)
        if n_chunks == 1:
            entries_per_pt = bpp // parameter.encoded_entry_size
            bytes_per_pt = entries_per_pt * parameter.encoded_entry_size
            flat = entries.reshape(-1)
        else:
            # entry i's piece k is bytes [k*bpp, (k+1)*bpp) of its encoding
            bytes_per_pt = bpp
            flat = np.zeros((entries.shape[0], n_chunks * bpp), dtype=np.uint8)
            flat[:, : entries.shape[1]] = entries
        padded = np.zeros((per_chunk * n_chunks * bytes_per_pt,), dtype=np.uint8)
        padded[: flat.size] = flat.reshape(-1)
        # [chunk, plaintext of the chunk, bytes]
        pieces = padded.reshape(per_chunk, n_chunks, bytes_per_pt).transpose(1, 0, 2)
        # reorder for sequential access at query time: within a chunk,
        # plaintext k*R + s goes to position s*d0 + k (R = per_chunk / d0)
        d0 = parameter.dimensions[0]
        pieces = pieces.reshape(n_chunks, d0, per_chunk // d0, -1).transpose(0, 2, 1, 3)
        pieces = pieces.reshape(n_chunks * per_chunk, bytes_per_pt)
        bits = coeffio.floor_log2(context.plaintext_modulus)
        coeffs = coeffio.bytes_to_coefficients_rows(pieces, bits, decode=False)
        rows = np.zeros((n_chunks * per_chunk, context.degree), dtype=np.int64)
        rows[:, : coeffs.shape[1]] = coeffs
        data = bfv.batch_encode_to_eval(context, rows)
        return ProcessedDatabase(context, data, rows.any(axis=1))


def _encoded_entries(database, parameter: IndexPirParameter) -> np.ndarray:
    """uint8 [entry_count, encoded_entry_size]: each entry with its size
    prefix (when encoded) and zero padding."""
    width = parameter.entry_size_encoding_width
    size = parameter.entry_size_in_bytes
    if isinstance(database, np.ndarray):
        if database.ndim != 2 or database.shape[1] > size:
            raise errors.PirError(f"database array of shape {database.shape} exceeds entry size {size}")
        entries = np.zeros((database.shape[0], size), dtype=np.uint8)
        entries[:, : database.shape[1]] = database
        lengths = np.full(database.shape[0], database.shape[1], dtype=np.int64)
    else:
        lengths = np.fromiter((len(e) for e in database), dtype=np.int64, count=len(database))
        if lengths.size and lengths.max() > size:
            raise errors.PirError(f"entry size {lengths.max()} too large")
        if lengths.size and (lengths == size).all():
            entries = np.frombuffer(b"".join(bytes(e) for e in database), dtype=np.uint8)
            entries = entries.reshape(len(database), size)
        else:
            entries = np.zeros((len(database), size), dtype=np.uint8)
            for i, e in enumerate(database):
                entries[i, : len(e)] = np.frombuffer(bytes(e), dtype=np.uint8)
    if not width:
        return entries
    prefix = np.stack(
        [((lengths >> (8 * b)) & 0xFF).astype(np.uint8) for b in range(width)], axis=1
    )
    return np.concatenate([prefix, entries], axis=1)
