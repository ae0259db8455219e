"""PKCS#11 (HSM) BCCSP provider (Fabric's bccsp/pkcs11/pkcs11.go).

The port's copy of the JAX package's `crypto/pkcs11.py`.  Fabric's HSM
story: private keys live on a Cryptoki token; the
host hashes, the token runs the ECDSA scalar ops (C_Sign / C_Verify on
CKM_ECDSA over the 32-byte digest), and the provider enforces the same
low-S normalization as the software path so signatures verify
identically everywhere. Public-key material is located by SKI
(CKA_ID), mirroring pkcs11.go's getECKey.

This module binds a standard Cryptoki shared object via ctypes
(`Cryptoki`), and `PKCS11Provider` implements the BCCSP surface on top
of a minimal session abstraction. The provider logic (SKI lookup,
DER wrap/unwrap, low-S, verify semantics) is unit-tested against a
faked token; the ctypes layer follows the PKCS#11 v2.40 ABI and
activates only when a `Library` path is configured, so a
missing/unloadable library raises `PKCS11Error` with a clear message
instead of probing anything (factory.go's pkcs11factory errors the same
way when the library is absent).
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import Dict, List, Optional, Sequence

from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.crypto.bccsp import (
    ECDSAPublicKey,
    Provider,
    SoftwareProvider,
    VerifyError,
)


class PKCS11Error(Exception):
    pass


# -- Cryptoki ABI subset (PKCS#11 v2.40) ------------------------------------

CKR_OK = 0
CKF_SERIAL_SESSION = 0x4
CKF_RW_SESSION = 0x2
CKU_USER = 1
CKM_ECDSA = 0x1041
CKO_PRIVATE_KEY = 0x3
CKO_PUBLIC_KEY = 0x2
CKA_CLASS = 0x0
CKA_ID = 0x102
CKA_EC_POINT = 0x181


class _CK_ATTRIBUTE(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_ulong),
        ("pValue", ctypes.c_void_p),
        ("ulValueLen", ctypes.c_ulong),
    ]


class _CK_MECHANISM(ctypes.Structure):
    _fields_ = [
        ("mechanism", ctypes.c_ulong),
        ("pParameter", ctypes.c_void_p),
        ("ulParameterLen", ctypes.c_ulong),
    ]


def _attr(atype: int, value: bytes) -> _CK_ATTRIBUTE:
    buf = ctypes.create_string_buffer(value, len(value))
    return _CK_ATTRIBUTE(
        atype, ctypes.cast(buf, ctypes.c_void_p), len(value)
    )


class Cryptoki:
    """Thin ctypes session over one Cryptoki library + token slot.
    Methods mirror the C_* calls pkcs11.go uses; any non-CKR_OK return
    raises PKCS11Error(rv)."""

    def __init__(self, library: str, pin: str, slot: Optional[int] = None):
        try:
            self._lib = ctypes.CDLL(library)
        except OSError as exc:
            raise PKCS11Error(
                f"cannot load PKCS#11 library {library!r}: {exc}"
            ) from exc
        self._check(self._lib.C_Initialize(None), "C_Initialize")
        if slot is None:
            count = ctypes.c_ulong(0)
            self._check(
                self._lib.C_GetSlotList(1, None, ctypes.byref(count)),
                "C_GetSlotList",
            )
            if count.value == 0:
                raise PKCS11Error("no PKCS#11 token slots present")
            slots = (ctypes.c_ulong * count.value)()
            self._check(
                self._lib.C_GetSlotList(1, slots, ctypes.byref(count)),
                "C_GetSlotList",
            )
            slot = slots[0]
        self._session = ctypes.c_ulong(0)
        self._check(
            self._lib.C_OpenSession(
                slot,
                CKF_SERIAL_SESSION | CKF_RW_SESSION,
                None,
                None,
                ctypes.byref(self._session),
            ),
            "C_OpenSession",
        )
        if pin:
            pin_b = pin.encode()
            self._check(
                self._lib.C_Login(self._session, CKU_USER, pin_b, len(pin_b)),
                "C_Login",
            )
        self._lock = threading.Lock()

    @staticmethod
    def _check(rv: int, call: str) -> None:
        if rv != CKR_OK:
            raise PKCS11Error(f"{call} failed: CKR=0x{rv:x}")

    def find_key(self, ski: bytes, private: bool) -> int:
        """Object handle for the key with CKA_ID == ski (getECKey)."""
        with self._lock:
            cls = CKO_PRIVATE_KEY if private else CKO_PUBLIC_KEY
            template = (_CK_ATTRIBUTE * 2)(
                _attr(CKA_CLASS, cls.to_bytes(8, "little")),
                _attr(CKA_ID, ski),
            )
            self._check(
                self._lib.C_FindObjectsInit(self._session, template, 2),
                "C_FindObjectsInit",
            )
            handle = ctypes.c_ulong(0)
            count = ctypes.c_ulong(0)
            try:
                self._check(
                    self._lib.C_FindObjects(
                        self._session,
                        ctypes.byref(handle),
                        1,
                        ctypes.byref(count),
                    ),
                    "C_FindObjects",
                )
            finally:
                self._lib.C_FindObjectsFinal(self._session)
            if count.value == 0:
                raise PKCS11Error(f"no key with SKI {ski.hex()} on token")
            return handle.value

    def sign_raw(self, key_handle: int, digest: bytes) -> bytes:
        """CKM_ECDSA C_Sign: 64-byte r||s over the digest."""
        with self._lock:
            mech = _CK_MECHANISM(CKM_ECDSA, None, 0)
            self._check(
                self._lib.C_SignInit(
                    self._session, ctypes.byref(mech), key_handle
                ),
                "C_SignInit",
            )
            out_len = ctypes.c_ulong(128)
            out = ctypes.create_string_buffer(128)
            self._check(
                self._lib.C_Sign(
                    self._session,
                    digest,
                    len(digest),
                    out,
                    ctypes.byref(out_len),
                ),
                "C_Sign",
            )
            return out.raw[: out_len.value]

    def verify_raw(self, key_handle: int, digest: bytes, rs: bytes) -> bool:
        """CKM_ECDSA C_Verify over r||s; CKR_SIGNATURE_INVALID -> False."""
        with self._lock:
            mech = _CK_MECHANISM(CKM_ECDSA, None, 0)
            self._check(
                self._lib.C_VerifyInit(
                    self._session, ctypes.byref(mech), key_handle
                ),
                "C_VerifyInit",
            )
            rv = self._lib.C_Verify(
                self._session, digest, len(digest), rs, len(rs)
            )
            if rv == CKR_OK:
                return True
            if rv in (0xC0, 0xC1):  # CKR_SIGNATURE_INVALID / _LEN_RANGE
                return False
            raise PKCS11Error(f"C_Verify failed: CKR=0x{rv:x}")


class PKCS11Provider(Provider):
    """BCCSP provider over a Cryptoki token. Token signatures are
    normalized to low-S and DER-wrapped so they are indistinguishable
    from software-path signatures (pkcs11.go signECDSA + utils.IsLowS);
    verification of PUBLIC keys runs on host (the token only holds OUR
    keys — same split as the reference, whose Verify with a plain
    public key goes through the software curve math)."""

    def __init__(self, token: Cryptoki):
        self._token = token
        self._sw = SoftwareProvider()
        self._handles: Dict[bytes, int] = {}

    # -- BCCSP surface -----------------------------------------------------
    def _priv_handle(self, ski: bytes) -> int:
        h = self._handles.get(ski)
        if h is None:
            h = self._token.find_key(ski, private=True)
            self._handles[ski] = h
        return h

    def sign_by_ski(self, ski: bytes, digest: bytes) -> bytes:
        """Sign with the token key identified by SKI; DER(low-S)."""
        rs = self._token.sign_raw(self._priv_handle(ski), digest)
        if len(rs) != 64:
            raise PKCS11Error(f"token returned {len(rs)}-byte signature")
        r = int.from_bytes(rs[:32], "big")
        s = int.from_bytes(rs[32:], "big")
        if not p256.is_low_s(s):
            s = p256.N - s  # toLowS, pkcs11.go:486
        return der.marshal_signature(r, s)

    def verify(self, key: ECDSAPublicKey, signature: bytes, digest: bytes) -> bool:
        # plain public keys verify on host exactly like SW (the token
        # adds nothing for keys it does not hold)
        return self._sw.verify(key, signature, digest)

    def batch_verify(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ) -> List[bool]:
        out = []
        for key, sig, dig in zip(keys, signatures, digests):
            try:
                out.append(self.verify(key, sig, dig))
            except VerifyError:
                out.append(False)
        return out
