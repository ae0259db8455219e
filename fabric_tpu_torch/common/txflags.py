"""Transaction validation codes and the per-block flags bitmask.

A copy of the JAX package's `common/txflags`. Code values are
wire-compatible with the reference (fabric-protos peer/transaction.proto
TxValidationCode; array semantics per pkg/txflags/validation_flags.go):
one uint8 per transaction, stored in block metadata TRANSACTIONS_FILTER,
and fed byte for byte into the commit hash.
"""

from __future__ import annotations

import enum

import numpy as np


class TxValidationCode(enum.IntEnum):
    VALID = 0
    NIL_ENVELOPE = 1
    BAD_PAYLOAD = 2
    BAD_COMMON_HEADER = 3
    BAD_CREATOR_SIGNATURE = 4
    INVALID_ENDORSER_TRANSACTION = 5
    INVALID_CONFIG_TRANSACTION = 6
    UNSUPPORTED_TX_PAYLOAD = 7
    BAD_PROPOSAL_TXID = 8
    DUPLICATE_TXID = 9
    ENDORSEMENT_POLICY_FAILURE = 10
    MVCC_READ_CONFLICT = 11
    PHANTOM_READ_CONFLICT = 12
    UNKNOWN_TX_TYPE = 13
    TARGET_CHAIN_NOT_FOUND = 14
    MARSHAL_TX_ERROR = 15
    NIL_TXACTION = 16
    EXPIRED_CHAINCODE = 17
    CHAINCODE_VERSION_CONFLICT = 18
    BAD_HEADER_EXTENSION = 19
    BAD_CHANNEL_HEADER = 20
    BAD_RESPONSE_PAYLOAD = 21
    BAD_RWSET = 22
    ILLEGAL_WRITESET = 23
    INVALID_WRITESET = 24
    INVALID_CHAINCODE = 25
    NOT_VALIDATED = 254
    INVALID_OTHER_REASON = 255


class ValidationFlags:
    """uint8-per-tx flags array (TRANSACTIONS_FILTER payload)."""

    def __init__(self, size: int, value: TxValidationCode = TxValidationCode.NOT_VALIDATED):
        self._flags = np.full(size, int(value), dtype=np.uint8)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ValidationFlags":
        out = cls(0)
        out._flags = np.frombuffer(raw, dtype=np.uint8).copy()
        return out

    def __len__(self) -> int:
        return len(self._flags)

    def set_flag(self, tx_index: int, flag: TxValidationCode) -> None:
        self._flags[tx_index] = int(flag)

    def flag(self, tx_index: int) -> TxValidationCode:
        return TxValidationCode(int(self._flags[tx_index]))

    def is_valid(self, tx_index: int) -> bool:
        return self._flags[tx_index] == int(TxValidationCode.VALID)

    def is_set_to(self, tx_index: int, flag: TxValidationCode) -> bool:
        return self._flags[tx_index] == int(flag)

    def all_validated(self) -> bool:
        return not (self._flags == int(TxValidationCode.NOT_VALIDATED)).any()

    def tobytes(self) -> bytes:
        return self._flags.tobytes()

    def asarray(self) -> np.ndarray:
        return self._flags

    def __eq__(self, other) -> bool:
        return isinstance(other, ValidationFlags) and np.array_equal(
            self._flags, other._flags
        )

    def __repr__(self) -> str:
        return f"ValidationFlags({[TxValidationCode(int(f)).name for f in self._flags]})"
