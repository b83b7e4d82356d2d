"""Private Nearest Neighbor Search: encrypted cosine-similarity scoring.

The port of she_tpu/pnns/pnns.py (reference
Sources/PrivateNearestNeighborSearch/*.swift): matrix packings
(denseColumn / denseRow / diagonal with baby-step-giant-step), the
Halevi-Shoup BSGS encrypted matrix-vector product (eprint 2018/244
Sec. 6.3), plaintext CRT for more than log2(t) bits of precision,
dense-row extraction, result packing via rotate-and-sum, and the client
and server protocol types.

The values and plaintexts are she_tpu's bit for bit. What differs is how
they are made: the packings build their slot vectors with numpy index
arithmetic (the diagonal packing without a Python loop over entries), every
packing SIMD-encodes all its plaintexts with ONE inverse NTT mod t
(bfv.encode_simd_batch), `PlaintextMatrix.to_eval` lifts and transforms
them with ONE forward NTT, and unpacking decodes them with one NTT. The
per-query `Server` (mul_transpose_matrix) stays she_tpu's: it is the
oracle of the batched server in pnns/serving.py.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from .. import errors
from .. import params as paramsmod
from ..bfv import bfv, keys
from ..core import poly as polymod
from ..core.poly import COEFF, EVAL, PolyRq
from ..ops import galois as galoismod
from ..utils import nt


class DistanceMetric(Enum):
    COSINE_SIMILARITY = "cosineSimilarity"


@dataclass(frozen=True)
class MatrixDimensions:
    row_count: int
    column_count: int

    def __post_init__(self):
        if self.row_count <= 0 or self.column_count <= 0:
            raise errors.PnnsError(f"invalid dimensions {self}")

    @property
    def count(self) -> int:
        return self.row_count * self.column_count


@dataclass(frozen=True)
class BabyStepGiantStep:
    """g ~ sqrt(D) decomposition (MatrixMultiplication.swift:25-61)."""

    vector_dimension: int
    baby_step: int
    giant_step: int

    @classmethod
    def create(cls, vector_dimension: int, baby_step: int | None = None) -> "BabyStepGiantStep":
        dim = nt.next_power_of_two(vector_dimension)
        if baby_step is None:
            baby_step = int(math.ceil(math.sqrt(dim)))
        return cls(dim, baby_step, -(-dim // baby_step))


@dataclass(frozen=True)
class MatrixPacking:
    kind: str  # 'denseColumn' | 'denseRow' | 'diagonal'
    bsgs: BabyStepGiantStep | None = None

    @classmethod
    def dense_column(cls):
        return cls("denseColumn")

    @classmethod
    def dense_row(cls):
        return cls("denseRow")

    @classmethod
    def diagonal(cls, bsgs: BabyStepGiantStep):
        return cls("diagonal", bsgs)


def _simd_dims(context: bfv.BfvContext) -> tuple[int, int]:
    d = context.simd_dimensions()
    if d is None:
        raise errors.PnnsError("parameters do not support SIMD encoding")
    return d


def plaintext_count(context: bfv.BfvContext, dims: MatrixDimensions, packing: MatrixPacking) -> int:
    """PlaintextMatrix.plaintextCount (PlaintextMatrix.swift:236-275)."""
    simd_rows, simd_cols = _simd_dims(context)
    n = context.degree
    if packing.kind == "denseColumn":
        cols_per_pt = simd_rows * (simd_cols // dims.row_count) if dims.row_count <= simd_cols else 0
        if cols_per_pt > 1:
            return -(-dims.column_count // cols_per_pt)
        return dims.column_count * (-(-dims.row_count // n))
    if packing.kind == "denseRow":
        if dims.column_count > simd_cols:
            raise errors.PnnsError("too many columns for denseRow")
        rows_per_pt = simd_rows * (simd_cols // nt.next_power_of_two(dims.column_count))
        return -(-dims.row_count // rows_per_pt)
    pts_per_col = -(-dims.row_count // n)
    return nt.next_power_of_two(dims.column_count) * pts_per_col


def _encode_vectors(context, vectors: list) -> list:
    """SIMD-encode slot vectors (each at most N values; missing slots are
    0) with one batched inverse NTT mod t -> one Coeff plaintext each."""
    n = context.degree
    rows = np.zeros((len(vectors), n), dtype=np.int64)
    for i, v in enumerate(vectors):
        rows[i, : len(v)] = v
    data = bfv.encode_simd_batch(context, rows)  # [P, 1, N]
    return [bfv.Plaintext(context, PolyRq(d, context.plaintext_context, COEFF)) for d in data]


def _stacked(plaintexts: list) -> bfv.Plaintext:
    """Plaintexts of one context and format -> one plaintext [P, L, N]."""
    p0 = plaintexts[0].poly
    data = torch.stack([pt.poly.data for pt in plaintexts])
    return bfv.Plaintext(plaintexts[0].context, PolyRq(data, p0.context, p0.fmt))


@dataclass
class PlaintextMatrix:
    dimensions: MatrixDimensions
    packing: MatrixPacking
    plaintexts: list  # [bfv.Plaintext]
    context: bfv.BfvContext

    @property
    def row_count(self):
        return self.dimensions.row_count

    @property
    def column_count(self):
        return self.dimensions.column_count

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_values(cls, context, dims: MatrixDimensions, packing: MatrixPacking, values):
        """values: row-major, already in [0, t)."""
        values = np.asarray(values, dtype=np.int64).reshape(-1)
        if len(values) != dims.count:
            raise errors.PnnsError(f"{len(values)} values for {dims}")
        if packing.kind == "denseColumn":
            vectors = cls._dense_column_vectors(context, dims, values)
        elif packing.kind == "denseRow":
            vectors = cls._dense_row_vectors(context, dims, values)
        else:
            vectors = cls._diagonal_vectors(context, dims, packing, values)
        expected = plaintext_count(context, dims, packing)
        assert len(vectors) == expected, (len(vectors), expected)
        return cls(dims, packing, _encode_vectors(context, vectors), context)

    @classmethod
    def from_signed_values(cls, context, dims, packing, signed_values, reduce: bool = False):
        t = context.plaintext_modulus
        signed = np.asarray(signed_values, dtype=np.int64).reshape(-1)
        if not reduce:
            lo, hi = -(t >> 1), (t - 1) >> 1
            if signed.size and (signed.min() < lo or signed.max() > hi):
                raise errors.PnnsError("signed value out of range")
        return cls.from_values(context, dims, packing, np.mod(signed, t))

    @staticmethod
    def _dense_column_vectors(context, dims, values) -> list:
        """PlaintextMatrix.swift:285-332."""
        n = context.degree
        _, simd_cols = _simd_dims(context)
        col_major = values.reshape(dims.row_count, dims.column_count).T
        vectors = []
        packed: list[int] = []
        for col in range(dims.column_count):
            for v in col_major[col].tolist():
                packed.append(v)
                if len(packed) == n:
                    vectors.append(packed)
                    packed = []
            next_col = len(packed) + dims.row_count
            if len(packed) < simd_cols and simd_cols + 1 <= next_col <= n:
                packed += [0] * ((n - len(packed)) % simd_cols)
            elif next_col > n:
                vectors.append(packed)
                packed = []
        if packed:
            vectors.append(packed)
        return vectors

    @staticmethod
    def _dense_row_vectors(context, dims, values) -> list:
        """PlaintextMatrix.swift:341-416."""
        n = context.degree
        simd_rows, simd_cols = _simd_dims(context)
        assert simd_rows == 2
        if dims.column_count > simd_cols:
            raise errors.PnnsError("too many columns")
        cc = dims.column_count
        pad_cols = nt.next_power_of_two(cc) - cc
        vectors = []
        packed: list[int] = []
        for row in values.reshape(dims.row_count, cc).tolist():
            packed.extend(row)
            packed.extend([0] * pad_cols)
            if len(packed) < simd_cols and len(packed) + cc > simd_cols:
                packed += [0] * (simd_cols - len(packed))
            if len(packed) + cc > n:
                vectors.append(packed)
                packed = []
        if packed:
            col_offset = len(packed) % simd_cols
            packed += [0] * (0 if col_offset == 0 else nt.next_power_of_two(col_offset) - col_offset)
            repeat = packed[:] if len(packed) <= simd_cols else packed[simd_cols:]
            while len(packed) < n:
                packed += repeat
            vectors.append(packed[:n])
        return vectors

    @staticmethod
    def _diagonal_vectors(context, dims, packing, values) -> np.ndarray:
        """Generalized diagonals with BSGS pre-rotation
        (PlaintextMatrix.swift:417-487), by index arithmetic: diagonal r
        holds data[c, (c + r) mod D'] at slot c (zero where that column is
        padding, D' the next power of two of the column count), cut into
        chunks of N slots; each half of chunk (r, k) is rolled right by
        (r // baby_step) * baby_step."""
        n = context.degree
        simd_rows, simd_cols = _simd_dims(context)
        assert simd_rows == 2
        if dims.column_count > simd_cols:
            raise errors.PnnsError("too many columns")
        rows, cols = dims.row_count, dims.column_count
        cols_pow2 = nt.next_power_of_two(cols)
        data = values.reshape(rows, cols)
        r = np.arange(cols_pow2)[:, None]
        c = np.arange(rows)[None, :]
        pc = (c + r) % cols_pow2
        packed = np.where(pc < cols, data[c, np.minimum(pc, cols - 1)], 0)  # [D', rows]
        pts_per_col = plaintext_count(context, dims, packing) // cols_pow2
        chunks = np.zeros((cols_pow2, pts_per_col * n), dtype=np.int64)
        chunks[:, :rows] = packed
        half = n // 2
        halves = chunks.reshape(cols_pow2, pts_per_col, 2, half)
        rotation = (np.arange(cols_pow2) // packing.bsgs.baby_step) * packing.bsgs.baby_step
        # np.roll(x, s)[k] == x[(k - s) mod len]
        src = (np.arange(half)[None, :] - rotation[:, None]) % half  # [D', half]
        rolled = np.take_along_axis(halves, src[:, None, None, :], axis=-1)
        return rolled.reshape(cols_pow2 * pts_per_col, n)

    # -- unpack ------------------------------------------------------------

    def unpack(self) -> list[int]:
        if self.packing.kind == "denseColumn":
            return self._unpack_dense_column()
        if self.packing.kind == "denseRow":
            return self._unpack_dense_row()
        return self._unpack_diagonal()

    def unpack_signed(self) -> list[int]:
        t = self.context.plaintext_modulus
        return [v - t if v > (t - 1) >> 1 else v for v in self.unpack()]

    def _decode_all(self) -> np.ndarray:
        """Every plaintext SIMD-decoded at once: int64 [P, N] of slot values."""
        ctx = self.context
        if not ctx.supports_simd_encoding:
            raise errors.SimdEncodingNotSupported(str(ctx.params))
        coeff = bfv.plaintext_to_coeff(_stacked(self.plaintexts)).poly  # [P, 1, N] mod t
        ev = polymod.forward_ntt(coeff).data[:, 0]
        return ev.index_select(-1, ctx.simd_index).cpu().numpy()

    def _unpack_dense_column(self) -> list[int]:
        simd_rows, simd_cols = _simd_dims(self.context)
        count = self.dimensions.count
        rc = self.row_count
        cols_per_pt = simd_rows * (simd_cols // rc) if rc <= simd_cols else 0
        col_major: list[int] = []
        for decoded in self._decode_all().tolist():
            if cols_per_pt > 1:
                per_row = rc * (simd_cols // rc)
                take = min(per_row, count - len(col_major))
                col_major += decoded[:take]
                take = min(per_row, count - len(col_major))
                col_major += decoded[simd_cols : simd_cols + take]
            else:
                in_row = len(col_major) % rc
                col_major += decoded[: min(len(decoded), rc - in_row)]
        if len(col_major) < count:
            raise errors.PnnsError("unpack underflow")
        arr = np.array(col_major[:count]).reshape(self.column_count, self.row_count)
        return [int(v) for v in arr.T.reshape(-1)]

    def _unpack_dense_row(self) -> list[int]:
        simd_rows, simd_cols = _simd_dims(self.context)
        count = self.dimensions.count
        cc = self.column_count
        cc_pow2 = nt.next_power_of_two(cc)
        pad = cc_pow2 - cc
        values: list[int] = []
        for decoded in self._decode_all().tolist():
            for simd_row in range(simd_rows):
                for ci in range(simd_cols // cc_pow2):
                    start = simd_row * simd_cols + ci * cc + ci * pad
                    values += decoded[start : start + min(cc, count - len(values))]
                    if len(values) == count:
                        return values
        if len(values) != count:
            raise errors.PnnsError("unpack underflow")
        return values

    def _unpack_diagonal(self) -> list[int]:
        bsgs = self.packing.bsgs
        middle = self.context.degree // 2
        cc_pow2 = nt.next_power_of_two(self.column_count)
        pts_per_col = plaintext_count(self.context, self.dimensions, self.packing) // cc_pow2
        chunk_size = bsgs.baby_step * pts_per_col
        decoded = self._decode_all()
        values = np.zeros((self.row_count, self.column_count), dtype=np.int64)
        cnt = 0
        diag_index = 0
        for chunk_index in range(0, len(decoded), chunk_size):
            rotation = (chunk_index // chunk_size) * bsgs.baby_step
            block = decoded[chunk_index : chunk_index + chunk_size]
            rotated = np.concatenate(
                (np.roll(block[:, :middle], -rotation, axis=1), np.roll(block[:, middle:], -rotation, axis=1)), axis=1
            )
            for d0 in range(0, len(rotated), pts_per_col):
                diag = rotated[d0 : d0 + pts_per_col].reshape(-1)[: self.row_count]
                c = np.arange(len(diag))
                vc = (diag_index + c) % cc_pow2
                keep = vc < self.column_count
                values[c[keep], vc[keep]] = diag[keep]
                cnt += int(keep.sum())
                diag_index += 1
        if cnt != self.dimensions.count:
            raise errors.PnnsError("diagonal unpack count mismatch")
        return [int(v) for v in values.reshape(-1)]

    # -- conversions -------------------------------------------------------

    def to_eval(self) -> "PlaintextMatrix":
        """Every Coeff plaintext to Eval over the ciphertext moduli, with
        one centered lift and one forward NTT for the whole matrix."""
        if any(pt.poly.fmt != COEFF for pt in self.plaintexts):
            pts = [bfv.plaintext_to_eval(self.context, pt) for pt in self.plaintexts]
        else:
            ev = bfv.plaintext_to_eval(self.context, _stacked(self.plaintexts)).poly
            pts = [bfv.Plaintext(self.context, PolyRq(d, ev.context, EVAL)) for d in ev.data]
        return PlaintextMatrix(self.dimensions, self.packing, pts, self.context)

    def encrypt(self, secret_key, err_rng=None) -> "CiphertextMatrix":
        cts = [bfv.encrypt(pt, secret_key, err_rng=err_rng) for pt in self.plaintexts]
        return CiphertextMatrix(self.dimensions, self.packing, cts, self.context)


@dataclass
class CiphertextMatrix:
    dimensions: MatrixDimensions
    packing: MatrixPacking
    ciphertexts: list
    context: bfv.BfvContext

    @property
    def row_count(self):
        return self.dimensions.row_count

    @property
    def column_count(self):
        return self.dimensions.column_count

    def decrypt(self, secret_key) -> PlaintextMatrix:
        pts = [bfv.decrypt(ct, secret_key) for ct in self.ciphertexts]
        return PlaintextMatrix(self.dimensions, self.packing, pts, self.context)

    def to_coeff(self) -> "CiphertextMatrix":
        return CiphertextMatrix(
            self.dimensions, self.packing, [bfv.ct_to_coeff(c) for c in self.ciphertexts], self.context
        )

    def to_eval(self) -> "CiphertextMatrix":
        return CiphertextMatrix(
            self.dimensions, self.packing, [bfv.ct_to_eval(c) for c in self.ciphertexts], self.context
        )

    def mod_switch_down_to_single(self) -> "CiphertextMatrix":
        return CiphertextMatrix(
            self.dimensions, self.packing, [bfv.mod_switch_down_to_single(c) for c in self.ciphertexts], self.context
        )

    def noise_budget(self, secret_key) -> float:
        return min(bfv.noise_budget(ct, secret_key) for ct in self.ciphertexts)

    # -- dense row extraction (CiphertextMatrix.swift:219-372) -------------

    @staticmethod
    def extract_dense_row_config(context, dims: MatrixDimensions) -> keys.EvaluationKeyConfig:
        if dims.row_count == 1:
            return keys.EvaluationKeyConfig()
        _, simd_cols = _simd_dims(context)
        n = context.degree
        elements = [galoismod.swapping_rows_element(n)]
        cc_pow2 = nt.next_power_of_two(dims.column_count)
        if cc_pow2 != simd_cols:
            elements.append(galoismod.rotating_columns_element(cc_pow2, n))
        return keys.EvaluationKeyConfig(tuple(elements))

    def extract_dense_row(self, row_index: int, evaluation_key) -> "CiphertextMatrix":
        if self.packing.kind != "denseRow":
            raise errors.PnnsError("extractDenseRow requires denseRow packing")
        simd_rows, simd_cols = _simd_dims(self.context)
        assert simd_rows == 2
        n = self.context.degree
        cc_pow2 = nt.next_power_of_two(self.column_count)
        rows_per_ct = (simd_cols // cc_pow2) * simd_rows
        ct_index = row_index // rows_per_ct
        if self.row_count == 1:
            return self

        def simd_slot_indices(r):
            start = (r % rows_per_ct) * cc_pow2
            batch = (start, start + cc_pow2)
            if batch[0] <= simd_cols < batch[1]:
                batch = (simd_cols, simd_cols + cc_pow2)
            elif batch[1] > simd_cols:
                padding = simd_cols % cc_pow2
                batch = (batch[0] + padding, batch[1] + padding)
            if ct_index == len(self.ciphertexts) - 1:
                batch = (batch[0], -(-batch[1] // simd_cols) * simd_cols)
            return batch

        batch = simd_slot_indices(row_index)
        last = row_index + 1
        while last < self.row_count and simd_slot_indices(last)[1] == batch[1]:
            last += 1
        first = row_index - 1 if row_index > 0 else 0
        while first > 0 and simd_slot_indices(first)[1] == batch[1]:
            first -= 1
        row_count_in_batch = last - first

        repeat_mask = [1] * cc_pow2 + [0] * (cc_pow2 * (row_count_in_batch - 1))
        repeat_mask += [0] * (nt.next_power_of_two(len(repeat_mask)) - len(repeat_mask))
        mask = [0] * batch[0]
        copies = 0
        while len(mask) < batch[1]:
            mask += repeat_mask
            copies += 1
        mask = mask[:n]
        mask += [0] * (n - len(mask))
        mask_pt = bfv.plaintext_to_eval(self.context, bfv.encode(self.context, mask, fmt="simd"))

        ct = bfv.ct_to_eval(self.ciphertexts[ct_index])
        ct = bfv.ct_to_coeff(bfv.ct_mul_pt(ct, mask_pt))
        copy_right = ct
        for _ in range(simd_cols // (copies * cc_pow2) - 1):
            copy_right = bfv.rotate_columns(copy_right, cc_pow2, evaluation_key)
            ct = bfv.ct_add(ct, copy_right)
        ct = bfv.ct_add(ct, bfv.swap_rows(ct, evaluation_key))
        return CiphertextMatrix(MatrixDimensions(1, self.column_count), self.packing, [ct], self.context)


# ---------------------------------------------------------------------------
# Extras: multi-step rotations and rotate-and-sum (_HomomorphicEncryptionExtras)
# ---------------------------------------------------------------------------


def rotate_columns_multi_step(ct, step: int, evaluation_key):
    """Compose a rotation from the available Galois keys
    (Extras/HeScheme.swift:62-105). The ciphertext may carry batch axes."""
    if step == 0:
        return ct
    n = ct.context.degree
    if evaluation_key.galois_key is None:
        raise errors.MissingGaloisKey()
    if galoismod.rotating_columns_element(step, n) in evaluation_key.galois_key.keys:
        return bfv.rotate_columns(ct, step, evaluation_key)
    elements = list(evaluation_key.galois_key.keys.keys())
    steps = [s for s in galoismod.steps_for(elements, n).values() if s is not None]
    positive = step + n // 2 if step < 0 else step
    plan = galoismod.plan_multi_step(steps, positive, n)
    if plan is None:
        raise errors.PnnsError(f"no multi-step plan for rotation {step}")
    for s, count in plan.items():
        for _ in range(count):
            ct = bfv.rotate_columns(ct, s, evaluation_key)
    return ct


def rotate_columns_and_sum(cts: list, step: int, evaluation_key):
    """acc = ((ct_k rotated + ct_{k-1}) rotated + ...) (Extras:113-133)."""
    cts = list(cts)
    acc = cts.pop()
    for ct in reversed(cts):
        acc = bfv.ct_add(rotate_columns_multi_step(acc, step, evaluation_key), ct)
    return acc


def swap_rows_and_add(swapping, adding_to, evaluation_key):
    return bfv.ct_add(bfv.swap_rows(swapping, evaluation_key), adding_to)


# ---------------------------------------------------------------------------
# BSGS matmul (MatrixMultiplication.swift:131-299)
# ---------------------------------------------------------------------------


def matmul_evaluation_key_config(context, plaintext_dims: MatrixDimensions, max_query_count: int) -> keys.EvaluationKeyConfig:
    _, simd_cols = _simd_dims(context)
    n = context.degree
    bsgs = BabyStepGiantStep.create(plaintext_dims.column_count)
    elements = [
        galoismod.rotating_columns_element(-1, n),
        galoismod.rotating_columns_element(-bsgs.baby_step, n),
        galoismod.swapping_rows_element(n),
    ]
    if simd_cols // plaintext_dims.row_count > 1:
        elements.append(galoismod.rotating_columns_element(1, n))
        if simd_cols > 16:
            elements.append(galoismod.rotating_columns_element(16, n))
        if simd_cols > 256:
            elements.append(galoismod.rotating_columns_element(256, n))
    config = keys.EvaluationKeyConfig(tuple(dict.fromkeys(elements)), False)
    dense_row_config = CiphertextMatrix.extract_dense_row_config(
        context, MatrixDimensions(max_query_count, plaintext_dims.column_count)
    )
    return config.union(dense_row_config)


def mul_transpose_vector(pt_matrix: PlaintextMatrix, ct_vector: CiphertextMatrix, evaluation_key):
    """plaintextMatrix @ vector^T -> list of canonical ciphertexts: the
    per-query form, one rotation, one plaintext_to_eval and one inner
    product at a time, as she_tpu computes it (the batched server's
    oracle)."""
    if pt_matrix.packing.kind != "diagonal":
        raise errors.PnnsError("mulTranspose requires diagonal packing")
    if ct_vector.packing.kind != "denseRow" or ct_vector.row_count != 1:
        raise errors.PnnsError("vector must be 1-row denseRow")
    bsgs = pt_matrix.packing.bsgs
    context = pt_matrix.context

    rotated_states = []
    state = ct_vector.ciphertexts[0]
    for step in range(bsgs.baby_step):
        rotated_states.append(state)
        if step != bsgs.baby_step - 1:
            state = bfv.rotate_columns(state, -1, evaluation_key)
    rotated_eval = [bfv.ct_to_eval(c) for c in rotated_states]

    result_ct_count = -(-pt_matrix.row_count // context.degree)
    results = []
    for result_index in range(result_ct_count):
        inner_products = []
        for giant in range(bsgs.giant_step):
            pt_count = min(len(rotated_eval), bsgs.vector_dimension - bsgs.baby_step * giant)
            pt_rows = [
                bfv.plaintext_to_eval(context, pt_matrix.plaintexts[result_ct_count * (j + bsgs.baby_step * giant)
                                                                    + result_index])
                for j in range(pt_count)
            ]
            prod = bfv.inner_product_ct_pt(rotated_eval[: len(pt_rows)], pt_rows)
            inner_products.append(bfv.ct_to_coeff(prod))
        results.append(rotate_columns_and_sum(inner_products, -bsgs.baby_step, evaluation_key))
    return results


def mul_transpose_matrix(pt_matrix: PlaintextMatrix, ct_matrix: CiphertextMatrix, evaluation_key):
    """plaintextMatrix @ ciphertextMatrix^T -> denseColumn CiphertextMatrix."""
    if pt_matrix.column_count != ct_matrix.column_count:
        raise errors.PnnsError("column count mismatch")
    context = pt_matrix.context
    simd_rows, simd_cols = _simd_dims(context)
    inner_products = []
    for row_index in range(ct_matrix.row_count):
        row = ct_matrix.extract_dense_row(row_index, evaluation_key)
        inner_products.extend(mul_transpose_vector(pt_matrix, row, evaluation_key))
    cols_per_simd_row = simd_cols // pt_matrix.row_count
    if cols_per_simd_row > 0:
        cols_per_ct = simd_rows * cols_per_simd_row
        packed = []
        for start in range(0, len(inner_products), cols_per_ct):
            group = inner_products[start : start + cols_per_ct]
            packed_rows = [
                rotate_columns_and_sum(group[s : s + cols_per_simd_row], pt_matrix.row_count, evaluation_key)
                for s in range(0, len(group), cols_per_simd_row)
            ]
            if len(group) > cols_per_simd_row:
                packed.append(swap_rows_and_add(packed_rows[1], packed_rows[0], evaluation_key))
            else:
                packed.append(packed_rows[0])
        inner_products = packed
    return CiphertextMatrix(
        MatrixDimensions(pt_matrix.row_count, ct_matrix.row_count),
        MatrixPacking.dense_column(),
        inner_products,
        context,
    )


# ---------------------------------------------------------------------------
# Client / Server (Client.swift, Server.swift, Config.swift)
# ---------------------------------------------------------------------------


def normalized_scaled_and_rounded(vectors: np.ndarray, scaling_factor: float) -> np.ndarray:
    """L2-normalize rows, scale, round to nearest int (PNNS Util.swift:75-90).
    Float32 arithmetic to match the reference."""
    v = vectors.astype(np.float32)
    norms = np.sqrt((v * v).sum(axis=1, dtype=np.float32))
    out = np.zeros(v.shape, dtype=np.int64)
    nz = norms != 0
    scaled = (v[nz] * np.float32(scaling_factor)) / norms[nz][:, None]
    out[nz] = np.round(scaled).astype(np.int64)
    return out


def max_scaling_factor(vector_dimension: int, plaintext_moduli: list[int]) -> int:
    t = np.float32(1)
    for m in plaintext_moduli:
        t = t * np.float32(m)
    return int(np.floor(np.sqrt((t - 1) / 2) - np.sqrt(np.float32(vector_dimension)) / 2))


@dataclass(frozen=True)
class ClientConfig:
    encryption_parameters: tuple  # one per plaintext modulus
    scaling_factor: int
    query_packing: MatrixPacking
    vector_dimension: int
    evaluation_key_config: keys.EvaluationKeyConfig
    distance_metric: DistanceMetric = DistanceMetric.COSINE_SIMILARITY
    extra_plaintext_moduli: tuple = ()

    @property
    def plaintext_moduli(self):
        return [p.plaintext_modulus for p in self.encryption_parameters]

    @classmethod
    def create(cls, encryption_parameters, scaling_factor, query_packing, vector_dimension,
               evaluation_key_config, distance_metric=DistanceMetric.COSINE_SIMILARITY,
               extra_plaintext_moduli=()):
        extra = tuple(
            paramsmod.EncryptionParameters(
                poly_degree=encryption_parameters.poly_degree,
                plaintext_modulus=t,
                coefficient_moduli=encryption_parameters.coefficient_moduli,
                error_std_dev=encryption_parameters.error_std_dev,
                security_level=encryption_parameters.security_level,
                scalar_bits=encryption_parameters.scalar_bits,
            )
            for t in extra_plaintext_moduli
        )
        return cls(
            (encryption_parameters,) + extra, scaling_factor, query_packing, vector_dimension,
            evaluation_key_config, distance_metric, tuple(extra_plaintext_moduli),
        )


@dataclass(frozen=True)
class ServerConfig:
    client_config: ClientConfig
    database_packing: MatrixPacking

    @property
    def distance_metric(self):
        return self.client_config.distance_metric

    @property
    def vector_dimension(self):
        return self.client_config.vector_dimension

    @property
    def encryption_parameters(self):
        return self.client_config.encryption_parameters


@dataclass
class Query:
    ciphertext_matrices: list  # one CiphertextMatrix per plaintext modulus


@dataclass
class Response:
    ciphertext_matrices: list
    entry_ids: list
    entry_metadatas: list

    def noise_budget(self, secret_key) -> float:
        return min(m.noise_budget(secret_key) for m in self.ciphertext_matrices)


@dataclass
class DatabaseRow:
    entry_id: int
    entry_metadata: bytes
    vector: np.ndarray  # float


@dataclass
class Database:
    rows: list


@dataclass
class ProcessedDatabase:
    contexts: list
    plaintext_matrices: list  # Eval PlaintextMatrix per plaintext modulus
    entry_ids: list
    entry_metadatas: list
    server_config: ServerConfig


def process_database(database: Database, config: ServerConfig, device=None) -> ProcessedDatabase:
    """ProcessedDatabase.swift:185-230, on `device` (the CUDA card by
    default): per plaintext modulus, the rounded vectors packed, encoded
    with one inverse NTT mod t and taken to Eval with one forward NTT."""
    if config.distance_metric != DistanceMetric.COSINE_SIMILARITY:
        raise errors.PnnsError("only cosineSimilarity supported")
    contexts = [bfv.get_bfv_context(ep, device) for ep in config.encryption_parameters]
    vectors = np.stack([row.vector for row in database.rows])
    rounded = normalized_scaled_and_rounded(vectors, float(config.client_config.scaling_factor))
    dims = MatrixDimensions(*rounded.shape)
    matrices = [
        PlaintextMatrix.from_signed_values(
            ctx, dims, config.database_packing, rounded, reduce=len(contexts) > 1
        ).to_eval()
        for ctx in contexts
    ]
    has_metadata = any(row.entry_metadata for row in database.rows)
    return ProcessedDatabase(
        contexts,
        matrices,
        [row.entry_id for row in database.rows],
        [row.entry_metadata for row in database.rows] if has_metadata else [],
        config,
    )


def _crt_compose(residues: list, moduli: list) -> np.ndarray:
    """Per plaintext modulus t_j, residues in [0, t_j) (equal-shape arrays)
    -> the signed CRT composition in (-T/2, T/2], T = prod(t_j), as an
    object array of Python ints."""
    T = math.prod(moduli)
    x = np.zeros(np.shape(residues[0]), dtype=object)
    for r, t in zip(residues, moduli):
        gi = T // t
        x = x + (np.asarray(r, dtype=object) * nt.inverse_mod(gi % t, t) % t) * gi
    x = x % T
    return np.where(x > (T - 1) // 2, x - T, x)


class Client:
    def __init__(self, config: ClientConfig, device=None):
        self.config = config
        self.contexts = [bfv.get_bfv_context(ep, device) for ep in config.encryption_parameters]

    def generate_secret_key(self, rng=None):
        return bfv.generate_secret_key(self.contexts[0], rng)

    def generate_evaluation_key(self, secret_key, err_rng=None):
        return keys.generate_evaluation_key(self.contexts[0], self.config.evaluation_key_config, secret_key, err_rng)

    def generate_query(self, vectors: np.ndarray, secret_key, err_rng=None) -> Query:
        rounded = normalized_scaled_and_rounded(vectors, float(self.config.scaling_factor))
        dims = MatrixDimensions(*rounded.shape)
        matrices = []
        for ctx in self.contexts:
            m = PlaintextMatrix.from_signed_values(
                ctx, dims, self.config.query_packing, rounded, reduce=len(self.contexts) > 1
            )
            matrices.append(m.encrypt(secret_key, err_rng=err_rng).to_coeff())
        return Query(matrices)

    def scores(self, response: Response, secret_key) -> np.ndarray:
        """The integer scores before the float scaling: each response matrix
        decrypted and unpacked, CRT-composed over the plaintext moduli and
        centered; int64 [database rows, query rows]."""
        dims = response.ciphertext_matrices[0].dimensions
        decoded = [m.decrypt(secret_key).unpack() for m in response.ciphertext_matrices]
        composed = _crt_compose(decoded, [ctx.plaintext_modulus for ctx in self.contexts])
        return composed.astype(np.int64).reshape(dims.row_count, dims.column_count)

    def decrypt(self, response: Response, secret_key):
        """-> (distances, entry_ids, metadatas); distances as float32
        row-major [database rows, query rows] (the reference's denseColumn)."""
        sf = np.float32(self.config.scaling_factor)
        distances = self.scores(response, secret_key).astype(np.float32) / (sf * sf)
        return distances, response.entry_ids, response.entry_metadatas


class Server:
    """The per-query server: mul_transpose_matrix for each query, as
    she_tpu's Server (the batched server of pnns/serving.py is held
    bit-identical to it)."""

    def __init__(self, database: ProcessedDatabase):
        if database.server_config.distance_metric != DistanceMetric.COSINE_SIMILARITY:
            raise errors.PnnsError("only cosineSimilarity supported")
        self.database = database

    def compute_response(self, query: Query, evaluation_key) -> Response:
        if len(query.ciphertext_matrices) != len(self.database.plaintext_matrices):
            raise errors.PnnsError("query matrix count mismatch")
        out = []
        for ct_matrix, pt_matrix in zip(query.ciphertext_matrices, self.database.plaintext_matrices):
            result = mul_transpose_matrix(pt_matrix, ct_matrix.to_coeff(), evaluation_key)
            out.append(result.mod_switch_down_to_single().to_coeff())
        return Response(out, self.database.entry_ids, self.database.entry_metadatas)


@dataclass
class DatabaseValidationResult:
    """Self-check metrics for a processed PNNS database, the analogue of the
    reference's ProcessedDatabaseWithParameters.validate
    (PrivateNearestNeighborSearch/ProcessedDatabase.swift:93-160)."""

    query_time_s: float
    response_time_s: float
    decrypt_time_s: float
    noise_budget: float
    max_abs_error: float


def validate_database(processed: ProcessedDatabase, trials: int = 1, n_queries: int = 1) -> DatabaseValidationResult:
    """Run fresh-key query/response/decrypt trials against the plaintext
    cosine-similarity reference; returns the min times across trials (the
    reference reports the fastest trial) and the worst-case decode error.
    Runs on the processed database's device."""
    config = processed.server_config.client_config
    client = Client(config, processed.contexts[0].device)
    server = Server(processed)
    best_q = best_r = best_d = float("inf")
    worst_err = 0.0
    budget = float("inf")
    rng = np.random.default_rng(0)
    for _ in range(max(1, trials)):
        # fresh keys per trial, matching ProcessedDatabase.swift:112-114
        sk = client.generate_secret_key()
        ek = client.generate_evaluation_key(sk)
        qvecs = rng.standard_normal((n_queries, config.vector_dimension)).astype(np.float32)
        t0 = time.perf_counter()
        query = client.generate_query(qvecs, sk)
        best_q = min(best_q, time.perf_counter() - t0)
        t0 = time.perf_counter()
        response = server.compute_response(query, ek)
        best_r = min(best_r, time.perf_counter() - t0)
        t0 = time.perf_counter()
        distances, _, _ = client.decrypt(response, sk)
        best_d = min(best_d, time.perf_counter() - t0)
        budget = min(budget, response.noise_budget(sk))
        # fixed-point reference (PNNS Util.swift:142-155): distances from
        # the *rounded* database rows and rounded query, both scaled.
        sf = float(config.scaling_factor)
        qr = normalized_scaled_and_rounded(qvecs, sf)
        expected = (_rounded_rows(processed) @ qr.T).astype(np.float64) / (sf * sf)
        worst_err = max(worst_err, float(np.max(np.abs(expected - distances.astype(np.float64)))))
    return DatabaseValidationResult(best_q, best_r, best_d, budget, worst_err)


def _rounded_rows(processed: ProcessedDatabase) -> np.ndarray:
    """Recover the signed fixed-point database rows from the plaintext
    matrices (exact CRT recompose across plaintext moduli)."""
    unpacked = [m.unpack() for m in processed.plaintext_matrices]
    vals = _crt_compose(unpacked, [ctx.plaintext_modulus for ctx in processed.contexts])
    dims = processed.plaintext_matrices[0].dimensions
    return vals.astype(np.int64).reshape(dims.row_count, dims.column_count)
