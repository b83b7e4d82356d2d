"""Fixed-width coefficient bit-packing: the bit layer of
she_tpu/io/serialize.py, under PIR entry packing and io/serialize.py.

Big-endian bitstream of (bitsPerCoeff - skipLSBs)-bit fields, as in the
reference (Sources/HomomorphicEncryption/CoefficientPacking.swift:34-217).
`bytes_to_coefficients_rows` and `coefficients_to_bytes_rows` are the
vectorized forms used by database processing and serialization: they
unpack or pack many equal-length rows in one pass; `unpack_fields` is
the unpacking on a torch tensor's device (SimplePIR packs its database
on the card with it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import errors


def ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def floor_log2(x: int) -> int:
    return x.bit_length() - 1


def coefficients_to_bytes_byte_count(coeff_count: int, bits_per_coeff: int, skip_lsbs: int = 0) -> int:
    serialized = bits_per_coeff - skip_lsbs
    return -(-(coeff_count * serialized) // 8)


def bytes_to_coefficients_coeff_count(byte_count: int, bits_per_coeff: int, decode: bool, skip_lsbs: int = 0) -> int:
    serialized = bits_per_coeff - skip_lsbs
    if decode:
        return 8 * byte_count // serialized
    return -(-(8 * byte_count) // serialized)


def _validate(bits_per_coeff: int, skip_lsbs: int):
    if not (0 < bits_per_coeff <= 64 and bits_per_coeff > skip_lsbs and skip_lsbs >= 0):
        raise errors.SerializationError(
            f"invalid packing bitsPerCoeff={bits_per_coeff} skipLSBs={skip_lsbs}"
        )


def coefficients_to_bytes_rows(rows, bits_per_coeff: int, skip_lsbs: int = 0) -> np.ndarray:
    """int [R, n] coefficient rows -> uint8 [R, bytes]: each row packed as
    coefficients_to_bytes would pack it, in one numpy pass."""
    _validate(bits_per_coeff, skip_lsbs)
    sbc = bits_per_coeff - skip_lsbs
    arr = np.asarray(rows).astype(np.uint64) >> np.uint64(skip_lsbs)
    if arr.ndim != 2:
        raise errors.SerializationError(f"expected [rows, coefficients], got {arr.shape}")
    shifts = np.arange(sbc - 1, -1, -1, dtype=np.uint64)
    bits = ((arr[:, :, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(arr.shape[0], -1), axis=1)  # zero-pads each row's last byte


def coefficients_to_bytes(coeffs, bits_per_coeff: int, skip_lsbs: int = 0) -> bytes:
    """coeffs: array of ints -> MSB-first bitstream of truncated coeffs."""
    return coefficients_to_bytes_rows(np.asarray(coeffs)[None, :], bits_per_coeff, skip_lsbs)[0].tobytes()


def bytes_to_coefficients_rows(
    rows: np.ndarray, bits_per_coeff: int, decode: bool, skip_lsbs: int = 0
) -> np.ndarray:
    """uint8 [R, B] byte rows -> int64 [R, count] coefficients, each row
    unpacked as bytes_to_coefficients would unpack its B bytes."""
    _validate(bits_per_coeff, skip_lsbs)
    rows = np.asarray(rows, dtype=np.uint8)
    if rows.ndim != 2:
        raise errors.SerializationError(f"expected [rows, bytes], got {rows.shape}")
    sbc = bits_per_coeff - skip_lsbs
    count = bytes_to_coefficients_coeff_count(rows.shape[1], bits_per_coeff, decode, skip_lsbs)
    bits = np.unpackbits(rows, axis=1)
    need = count * sbc
    if bits.shape[1] < need:
        bits = np.pad(bits, ((0, 0), (0, need - bits.shape[1])))
    bits = bits[:, :need].reshape(rows.shape[0], count, sbc)
    weights = np.uint64(1) << np.arange(sbc - 1, -1, -1, dtype=np.uint64)
    out = (bits.astype(np.uint64) * weights).sum(axis=2, dtype=np.uint64)
    return (out << np.uint64(skip_lsbs)).astype(np.int64)


WINDOW_MAX_BITS = 57  # a field and the 7 bits before it in its first byte fit 64 bits


def unpack_fields(rows: torch.Tensor, sbc: int, count: int) -> torch.Tensor:
    """uint8 [R, B] -> int64 [R, count]: the first `count` sbc-bit fields
    of each row's big-endian bitstream (zero past its B bytes), on the
    rows' device, for sbc <= WINDOW_MAX_BITS.

    A group of sbc / gcd(sbc, 8) bytes holds 8 / gcd(sbc, 8) whole fields,
    so field m of every group is the same window of byte columns: its
    bytes are or-ed in big-endian into an int64, shifted down and masked.
    The window can set bit 63; the arithmetic shift then copies it into
    bits the mask drops (the shift leaves at least sbc bits below them)."""
    if not 0 < sbc <= WINDOW_MAX_BITS:
        raise errors.SerializationError(f"unpack_fields takes 1..{WINDOW_MAX_BITS} bits, got {sbc}")
    g = math.gcd(sbc, 8)
    group_bytes, group_fields = sbc // g, 8 // g
    groups = -(-count // group_fields)
    rows = rows[:, : groups * group_bytes]
    if rows.shape[1] < groups * group_bytes:
        rows = torch.nn.functional.pad(rows, (0, groups * group_bytes - rows.shape[1]))
    grouped = rows.reshape(rows.shape[0], groups, group_bytes)
    out = torch.empty((rows.shape[0], groups, group_fields), dtype=torch.int64, device=rows.device)
    for m in range(group_fields):
        first, lead = divmod(m * sbc, 8)
        width = -(-(lead + sbc) // 8)
        window = grouped[:, :, first].to(torch.int64)
        for w in range(1, width):
            window = (window << 8) | grouped[:, :, first + w]
        out[:, :, m] = (window >> (8 * width - lead - sbc)) & ((1 << sbc) - 1)
    return out.reshape(rows.shape[0], -1)[:, :count]


def bytes_to_coefficients(data: bytes, bits_per_coeff: int, decode: bool, skip_lsbs: int = 0) -> np.ndarray:
    """Inverse of coefficients_to_bytes -> int64 array."""
    row = np.frombuffer(bytes(data), dtype=np.uint8)[None, :]
    return bytes_to_coefficients_rows(row, bits_per_coeff, decode, skip_lsbs)[0]
