"""The port's PKCS#11 provider (`crypto/pkcs11.py`) against the JAX
package's, on tests/test_pkcs11.py's faked Cryptoki token, which signs
with the port's `hostec`: the same token output becomes the same DER bytes
in both providers (normalised to low-S, the raw form high-S every other
call), those signatures verify through both SoftwareProviders, the key
handle is cached by SKI, an unknown SKI raises, and batch masks agree."""

import hashlib

import numpy as np
import pytest

from fabric_tpu.crypto import bccsp as jbccsp
from fabric_tpu.crypto import pkcs11 as jpkcs11
from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.crypto import bccsp, hostec, pkcs11


class FakeToken:
    """Cryptoki stand-in: one resident P-256 key addressed by SKI, signing
    with the port's hostec. Its raw output is high-S every other digest
    (so the providers' toLowS runs) and the same for a digest each time it
    is asked, so two providers see one token output."""

    def __init__(self, error=pkcs11.PKCS11Error):
        rng = np.random.RandomState(11)
        self.priv = int.from_bytes(rng.bytes(32), "big") % (p256.N - 1) + 1
        self.pub = hostec.scalar_base_mult(self.priv)
        self.ski = hashlib.sha256(b"token-key").digest()[:20]
        self.error = error
        self.find_calls = 0
        self.raw = {}

    def find_key(self, ski, private):
        self.find_calls += 1
        if ski != self.ski:
            raise self.error(f"no key with SKI {ski.hex()} on token")
        return 7 if private else 8

    def sign_raw(self, handle, digest):
        assert handle == 7
        if digest not in self.raw:
            r, s = hostec.sign_digest(self.priv, digest)
            if len(self.raw) % 2 == 0:
                s = p256.N - s  # the high-S form a raw HSM may return
            self.raw[digest] = r.to_bytes(32, "big") + s.to_bytes(32, "big")
        return self.raw[digest]


def test_token_signatures_equal_jax_and_verify():
    token = FakeToken()
    port, jax = pkcs11.PKCS11Provider(token), jpkcs11.PKCS11Provider(token)
    pub, jpub = bccsp.ECDSAPublicKey(*token.pub), jbccsp.ECDSAPublicKey(*token.pub)
    for i in range(6):
        digest = port.hash(b"msg-%d" % i)
        sig = port.sign_by_ski(token.ski, digest)
        assert sig == jax.sign_by_ski(token.ski, digest)
        r, s = der.unmarshal_signature(sig)
        assert p256.is_low_s(s) and r == int.from_bytes(token.raw[digest][:32], "big")
        assert port.verify(pub, sig, digest) and jax.verify(jpub, sig, digest)
        assert bccsp.SoftwareProvider().verify(pub, sig, digest)
        assert jbccsp.SoftwareProvider().verify(jpub, sig, digest)
    assert sum(not p256.is_low_s(int.from_bytes(raw[32:], "big")) for raw in token.raw.values()) == 3


def test_handle_cache_and_unknown_ski():
    token = FakeToken()
    prov = pkcs11.PKCS11Provider(token)
    digest = prov.hash(b"x")
    prov.sign_by_ski(token.ski, digest)
    prov.sign_by_ski(token.ski, digest)
    assert token.find_calls == 1
    with pytest.raises(pkcs11.PKCS11Error):
        prov.sign_by_ski(b"\x00" * 20, digest)


def test_short_token_output_raises():
    token = FakeToken()
    token.sign_raw = lambda handle, digest: b"\x01" * 63
    with pytest.raises(pkcs11.PKCS11Error, match="63-byte"):
        pkcs11.PKCS11Provider(token).sign_by_ski(token.ski, b"\x00" * 32)


def test_batch_verify_masks_equal_jax():
    token = FakeToken()
    port, jax = pkcs11.PKCS11Provider(token), jpkcs11.PKCS11Provider(token)
    pub, jpub = bccsp.ECDSAPublicKey(*token.pub), jbccsp.ECDSAPublicKey(*token.pub)
    digest = port.hash(b"m")
    good = port.sign_by_ski(token.ski, digest)
    r, s = der.unmarshal_signature(good)
    high = der.marshal_signature(r, p256.N - s)
    sigs = [good, b"\x30\x02\x01\x01", good, high]
    digests = [digest, digest, port.hash(b"other"), digest]
    got = port.batch_verify([pub] * 4, sigs, digests)
    assert got == jax.batch_verify([jpub] * 4, sigs, digests) == [True, False, False, False]
    with pytest.raises(bccsp.VerifyError):
        port.verify(pub, high, digest)
