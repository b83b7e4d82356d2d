"""Typed errors, mirroring the reference's HeError/PirError/PnnsError enums
(reference: Sources/HomomorphicEncryption/Error.swift:19-54)."""

from __future__ import annotations


class HeError(Exception):
    """Base error for the HE core."""


class InvalidEncryptionParameters(HeError):
    pass


class InsecureEncryptionParameters(HeError):
    pass


class InvalidDegree(HeError):
    pass


class InvalidModulus(HeError):
    pass


class InvalidFormat(HeError):
    pass


class IncompatibleContexts(HeError):
    pass


class NotEnoughPrimes(HeError):
    pass


class InvalidCiphertext(HeError):
    pass


class InvalidPlaintext(HeError):
    pass


class InvalidCorrectionFactor(HeError):
    pass


class MissingGaloisKey(HeError):
    pass


class MissingRelinearizationKey(HeError):
    pass


class SerializationError(HeError):
    pass


class SimdEncodingNotSupported(HeError):
    pass


class InvalidArgument(HeError):
    """An API argument violates a documented precondition."""


class EncodingError(HeError):
    pass


class PirError(Exception):
    """Base error for the PIR layer."""


class PnnsError(Exception):
    """Base error for the PNNS layer."""
