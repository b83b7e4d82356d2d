"""Symmetric PIR: OPRF-hardened keyword PIR with encrypted database rows.

The port of she_tpu/pir/symmetric_pir.py:21-127, with AES-GCM from
utils/aes_gcm.py in place of the cryptography package's AESGCM.
Reference: Sources/PrivateInformationRetrieval/SymmetricPir/*.swift.
Config OPRF_P384_AES_GCM_192_NONCE_96_TAG_128: the VOPRF output (48 bytes)
splits into oblivious keyword (first 16) / AES-GCM nonce (first 12) /
AES-GCM-192 key (last 24); every database row value is AES-GCM encrypted
under its row-derived key and the keyword replaced by the oblivious keyword.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .. import errors
from ..utils import aes_gcm
from . import oprf


class SymmetricPirConfigType(Enum):
    OPRF_P384_AES_GCM_192_NONCE_96_TAG_128 = "OPRF_P384_AES_GCM_192_NONCE_96_TAG_128"

    @property
    def oprf_key_size(self) -> int:
        return 48

    @property
    def oprf_output_size(self) -> int:
        return 48

    @property
    def oblivious_keyword_size(self) -> int:
        return 16

    @property
    def entry_encryption_key_size(self) -> int:
        return 24

    @property
    def nonce_size(self) -> int:
        return 12

    @property
    def tag_size(self) -> int:
        return 16


@dataclass
class ParsedOprfOutput:
    oblivious_keyword: bytes
    nonce: bytes
    secret_key: bytes

    @classmethod
    def parse(cls, output: bytes, config_type: SymmetricPirConfigType) -> "ParsedOprfOutput":
        return cls(
            output[: config_type.oblivious_keyword_size],
            output[: config_type.nonce_size],
            output[-config_type.entry_encryption_key_size :],
        )


@dataclass
class SymmetricPirConfig:
    oprf_secret_key: bytes
    config_type: SymmetricPirConfigType = SymmetricPirConfigType.OPRF_P384_AES_GCM_192_NONCE_96_TAG_128

    def __post_init__(self):
        if len(self.oprf_secret_key) != self.config_type.oprf_key_size:
            raise errors.PirError("invalid OPRF key size")
        oprf.OprfPrivateKey(self.oprf_secret_key)  # validates scalar

    def client_config(self) -> "SymmetricPirClientConfig":
        pk = oprf.OprfPrivateKey(self.oprf_secret_key).public_key
        return SymmetricPirClientConfig(pk.oprf_representation, self.config_type)


@dataclass
class SymmetricPirClientConfig:
    server_public_key: bytes
    config_type: SymmetricPirConfigType


class OprfServer:
    """Blind-evaluates keyword queries (SymmetricPirProtocol.swift:40-61)."""

    def __init__(self, config: SymmetricPirConfig):
        self.private_key = oprf.OprfPrivateKey(config.oprf_secret_key)

    def compute_response(self, query: bytes) -> oprf.BlindEvaluation:
        return self.private_key.blind_evaluate(query)


class OprfClient:
    def __init__(self, client_config: SymmetricPirClientConfig):
        self.public_key = oprf.OprfPublicKey(client_config.server_public_key)
        self.config_type = client_config.config_type

    def query_context(self, keyword: bytes) -> oprf.BlindedInput:
        return self.public_key.blind(keyword)

    def parse(self, response: oprf.BlindEvaluation, context: oprf.BlindedInput) -> ParsedOprfOutput:
        output = self.public_key.finalize(context, response)
        return ParsedOprfOutput.parse(output, self.config_type)

    def decrypt(self, encrypted_entry: bytes, parsed: ParsedOprfOutput) -> bytes:
        """Unseal a row's value; raises aes_gcm.InvalidTag if it was not
        sealed under this keyword's key."""
        return aes_gcm.unseal(parsed.secret_key, parsed.nonce, encrypted_entry)


def symmetric_pir_process(
    database: list[tuple[bytes, bytes]], config: SymmetricPirConfig
) -> list[tuple[bytes, bytes]]:
    """Encrypt every row value under its per-row derived key and replace the
    keyword with the oblivious keyword (SymmetricPirDatabase.swift:193-240)."""
    key = oprf.OprfPrivateKey(config.oprf_secret_key)
    ct = config.config_type
    out = []
    for keyword, value in database:
        output = key.evaluate(keyword)
        assert len(output) == ct.oprf_output_size
        parsed = ParsedOprfOutput.parse(output, ct)
        sealed = aes_gcm.seal(parsed.secret_key, parsed.nonce, bytes(value))  # ct || tag
        out.append((parsed.oblivious_keyword, sealed))
    return out
