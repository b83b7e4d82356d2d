"""Encryption parameters for the BFV RLWE scheme (a copy of she_tpu.params).

Reproduces the reference's parameter registry and validation rules so that
every predefined parameter set (including the exact NTT-friendly primes) is
bit-identical (reference: Sources/HomomorphicEncryption/EncryptionParameters.swift:16-537).

Scalar-width note: the reference is generic over UInt32/UInt64 scalars.
`scalar_bits` (32 or 64) selects which reference scalar type semantics
(Barrett bounds, rnsCorrectionFactor, mTilde, B_sk prime sizes) the
parameter set follows. The torch port holds every coefficient as one int64
word at both widths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from functools import lru_cache

import numpy as np

from . import errors
from .utils import nt


class ErrorStdDev(Enum):
    """RLWE error standard deviation (EncryptionParameters.swift:19-40)."""

    STDDEV_32 = 3.2
    STDDEV_64 = 6.4


class SecurityLevel(Enum):
    QUANTUM128 = "quantum128"
    UNCHECKED = "unchecked"


# Lattice-estimator-derived security table: N -> max log2(Q)
# (EncryptionParameters.swift:192-219).
_MAX_LOG2_Q = {1024: 21, 2048: 41, 4096: 83, 8192: 165, 16384: 330, 32768: 660}


def max_log2_coefficient_modulus(
    degree: int,
    security_level: SecurityLevel,
    error_std_dev: ErrorStdDev = ErrorStdDev.STDDEV_32,
) -> int:
    if security_level == SecurityLevel.UNCHECKED:
        return 2**62
    if error_std_dev == ErrorStdDev.STDDEV_64:
        if degree == 2048:
            return 42
        raise errors.InvalidEncryptionParameters(
            f"stdDev64 only supported for degree 2048, got {degree}"
        )
    if degree not in _MAX_LOG2_Q:
        raise errors.InvalidDegree(str(degree))
    return _MAX_LOG2_Q[degree]


def rns_correction_factor(scalar_bits: int) -> int:
    """gamma for BFV decryption scaling (reference Scalar.swift:498-526)."""
    if scalar_bits == 32:
        return (1 << 30) - 20405
    if scalar_bits == 64:
        return (1 << 62) - 40797
    raise ValueError(scalar_bits)


def m_tilde(scalar_bits: int) -> int:
    """BEHZ m~ redundant modulus (reference Scalar.swift:498-526)."""
    if scalar_bits == 32:
        return 1 << 16
    if scalar_bits == 64:
        return 1 << 32
    raise ValueError(scalar_bits)


def max_single_modulus(scalar_bits: int) -> int:
    """Largest supported modulus: 2^(bits-2) - 1 (Modulus.swift:177-180)."""
    return (1 << (scalar_bits - 2)) - 1


@dataclass(frozen=True)
class EncryptionParameters:
    """Validated BFV encryption parameters.

    The last coefficient modulus is reserved as the key-switching special
    modulus (hybrid key-switching with alpha=1), as in the reference.
    """

    poly_degree: int
    plaintext_modulus: int
    coefficient_moduli: tuple[int, ...]
    error_std_dev: ErrorStdDev = ErrorStdDev.STDDEV_32
    security_level: SecurityLevel = SecurityLevel.QUANTUM128
    scalar_bits: int = 64

    def __post_init__(self) -> None:
        object.__setattr__(self, "coefficient_moduli", tuple(self.coefficient_moduli))
        if self.scalar_bits not in (32, 64):
            raise errors.InvalidEncryptionParameters(f"scalar_bits={self.scalar_bits}")
        if not nt.is_power_of_two(self.poly_degree):
            raise errors.InvalidEncryptionParameters(f"degree {self.poly_degree}")
        # Reference sums log2 in Float (32-bit); replicate for edge parity.
        log2q = np.float32(0)
        for q in self.coefficient_moduli:
            log2q += np.float32(math.log2(np.float32(q)))
        if self.security_level != SecurityLevel.UNCHECKED:
            limit = max_log2_coefficient_modulus(
                self.poly_degree, self.security_level, ErrorStdDev.STDDEV_32
            )
            if log2q > np.float32(limit) or self.error_std_dev != ErrorStdDev.STDDEV_32:
                raise errors.InsecureEncryptionParameters(str(self))
        if len(self.coefficient_moduli) > 32:
            raise errors.InvalidEncryptionParameters("more than 32 moduli")
        for q in self.coefficient_moduli:
            if not (q > self.plaintext_modulus and nt.is_ntt_modulus(q, self.poly_degree)):
                raise errors.InvalidEncryptionParameters(f"modulus {q}")
        gamma = rns_correction_factor(self.scalar_bits)
        mt = m_tilde(self.scalar_bits)
        for modulus in (*self.coefficient_moduli, self.plaintext_modulus):
            if not nt.is_prime(modulus):
                raise errors.InvalidEncryptionParameters(f"{modulus} not prime")
            if not 1 <= modulus <= max_single_modulus(self.scalar_bits):
                raise errors.InvalidEncryptionParameters(f"{modulus} out of range")
            if modulus in (gamma, mt):
                raise errors.InvalidEncryptionParameters(
                    f"{modulus} collides with gamma/mTilde"
                )

    @property
    def supports_simd_encoding(self) -> bool:
        return nt.is_ntt_modulus(self.plaintext_modulus, self.poly_degree)

    @property
    def supports_evaluation_key(self) -> bool:
        return len(self.coefficient_moduli) > 1

    @property
    def bits_per_plaintext(self) -> int:
        return self.poly_degree * (self.plaintext_modulus.bit_length() - 1)

    @property
    def bytes_per_plaintext(self) -> int:
        return self.bits_per_plaintext // 8

    @property
    def moduli_count(self) -> int:
        return len(self.coefficient_moduli)

    def __str__(self) -> str:  # pragma: no cover
        return (
            f"EncryptionParameters(degree={self.poly_degree}, "
            f"t={self.plaintext_modulus}, q={list(self.coefficient_moduli)}, "
            f"scalar_bits={self.scalar_bits})"
        )


@dataclass(frozen=True)
class _PredefinedSet:
    poly_degree: int
    security_level: SecurityLevel
    plaintext_modulus: int
    coefficient_moduli: tuple[int, ...]
    supports_scalar32: bool
    error_std_dev: ErrorStdDev = ErrorStdDev.STDDEV_32


# All 17 predefined parameter sets with exact moduli
# (EncryptionParameters.swift:243-537). These values must be reproduced
# verbatim for wire-format interoperability with the reference.
PREDEFINED_RLWE_PARAMETERS: dict[str, _PredefinedSet] = {
    "insecure_n_16_logq_60_logt_15": _PredefinedSet(
        16, SecurityLevel.UNCHECKED, (1 << 14) + 33, ((1 << 60) - 16383,), False
    ),
    "insecure_n_512_logq_4x60_logt_20": _PredefinedSet(
        512,
        SecurityLevel.UNCHECKED,
        (1 << 19) + 1025,
        ((1 << 59) + 13313, (1 << 59) + 16385, (1 << 59) + 23553, (1 << 59) + 48129),
        False,
    ),
    "insecure_n_8_logq_5x18_logt_5": _PredefinedSet(
        8,
        SecurityLevel.UNCHECKED,
        (1 << 4) + 1,
        ((1 << 17) + 177, (1 << 17) + 225, (1 << 17) + 369, (1 << 17) + 417, (1 << 17) + 545),
        True,
    ),
    "n_4096_logq_16_33_33_logt_4": _PredefinedSet(
        4096,
        SecurityLevel.QUANTUM128,
        (1 << 3) + 3,
        ((1 << 16) - 24575, (1 << 33) - 81919, (1 << 33) - 90111),
        False,
    ),
    "n_4096_logq_27_28_28_logt_13": _PredefinedSet(
        4096,
        SecurityLevel.QUANTUM128,
        (1 << 12) + 3,
        ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727),
        True,
    ),
    "n_4096_logq_27_28_28_logt_16": _PredefinedSet(
        4096,
        SecurityLevel.QUANTUM128,
        (1 << 15) + 8193,
        ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727),
        True,
    ),
    "n_4096_logq_27_28_28_logt_17": _PredefinedSet(
        4096,
        SecurityLevel.QUANTUM128,
        (1 << 16) + 1,
        ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727),
        True,
    ),
    "n_4096_logq_27_28_28_logt_4": _PredefinedSet(
        4096,
        SecurityLevel.QUANTUM128,
        (1 << 3) + 3,
        ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727),
        True,
    ),
    "n_4096_logq_27_28_28_logt_5": _PredefinedSet(
        4096,
        SecurityLevel.QUANTUM128,
        (1 << 4) + 1,
        ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727),
        True,
    ),
    "n_4096_logq_27_28_28_logt_6": _PredefinedSet(
        4096,
        SecurityLevel.QUANTUM128,
        (1 << 5) + 5,
        ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727),
        True,
    ),
    "n_8192_logq_28_60_60_logt_20": _PredefinedSet(
        8192,
        SecurityLevel.QUANTUM128,
        (1 << 19) + 32769,
        ((1 << 28) - 65535, (1 << 60) - 16383, (1 << 60) - 98303),
        False,
    ),
    "n_8192_logq_29_60_60_logt_15": _PredefinedSet(
        8192,
        SecurityLevel.QUANTUM128,
        (1 << 14) + 27,
        ((1 << 29) - 180223, (1 << 60) - 16383, (1 << 60) - 98303),
        False,
    ),
    "n_8192_logq_3x55_logt_24": _PredefinedSet(
        8192,
        SecurityLevel.QUANTUM128,
        (1 << 23) + 16385,
        ((1 << 55) - 311295, (1 << 55) - 1392639, (1 << 55) - 1507327),
        False,
    ),
    "n_8192_logq_3x55_logt_29": _PredefinedSet(
        8192,
        SecurityLevel.QUANTUM128,
        (1 << 28) + 147457,
        ((1 << 55) - 311295, (1 << 55) - 1392639, (1 << 55) - 1507327),
        False,
    ),
    "n_8192_logq_3x55_logt_30": _PredefinedSet(
        8192,
        SecurityLevel.QUANTUM128,
        (1 << 29) + 32769,
        ((1 << 55) - 311295, (1 << 55) - 1392639, (1 << 55) - 1507327),
        False,
    ),
    "n_8192_logq_3x55_logt_42": _PredefinedSet(
        8192,
        SecurityLevel.QUANTUM128,
        (1 << 41) + 32769,
        ((1 << 55) - 311295, (1 << 55) - 1392639, (1 << 55) - 1507327),
        False,
    ),
    "n_8192_logq_40_60_60_logt_26": _PredefinedSet(
        8192,
        SecurityLevel.QUANTUM128,
        (1 << 25) + 278529,
        ((1 << 40) - 147455, (1 << 60) - 16383, (1 << 60) - 98303),
        False,
    ),
}


def predefined_supports_scalar32(name: str) -> bool:
    return PREDEFINED_RLWE_PARAMETERS[name].supports_scalar32


@lru_cache(maxsize=None)
def from_predefined(name: str, scalar_bits: int = 64) -> EncryptionParameters:
    """Build EncryptionParameters from a predefined set by name."""
    ps = PREDEFINED_RLWE_PARAMETERS[name]
    if scalar_bits == 32 and not ps.supports_scalar32:
        raise errors.InvalidEncryptionParameters(
            f"{name} does not support 32-bit scalars"
        )
    return EncryptionParameters(
        poly_degree=ps.poly_degree,
        plaintext_modulus=ps.plaintext_modulus,
        coefficient_moduli=ps.coefficient_moduli,
        error_std_dev=ps.error_std_dev,
        security_level=ps.security_level,
        scalar_bits=scalar_bits,
    )
