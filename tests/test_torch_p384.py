"""The port's P-384 (`common/p384.py`, the Idemix revocation key) against the
`cryptography` package, which the JAX package uses for the same key.

For seeded scalars (the edges 1 and n - 1 among them): the port's PKCS#8 and
SubjectPublicKeyInfo PEMs equal `cryptography`'s byte for byte; each side
loads the other's keys; the port's signatures over a SHA-256 digest verify
under `cryptography` with `ECDSA(Prehashed(SHA256))`, as
`fabric_tpu/idemix/scheme.py` signs, and `cryptography`'s under the port; a
flipped bit of the signature or of the digest, another key's signature, a high S that
`cryptography` made valid, and non-canonical DER are decided alike by both.
"""

import hashlib
import random

import pytest

pytest.importorskip("cryptography", reason="the reference key is cryptography's")

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, utils

from fabric_tpu_torch.common import der, p384
from fabric_tpu_torch.common.x509 import X509Error

ECDSA = ec.ECDSA(utils.Prehashed(hashes.SHA256()))
SCALARS = [1, 2, p384.N - 1] + [random.Random(k).randrange(1, p384.N) for k in range(5)]


def _theirs(d):
    return ec.derive_private_key(d, ec.SECP384R1())


def _their_pems(key):
    return (key.private_bytes(serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                              serialization.NoEncryption()),
            key.public_key().public_bytes(serialization.Encoding.PEM,
                                          serialization.PublicFormat.SubjectPublicKeyInfo))


def _their_verdict(key, sig, digest) -> bool:
    try:
        key.public_key().verify(sig, digest, ECDSA)
        return True
    except InvalidSignature:
        return False


def _our_verdict(key, sig, digest) -> bool:
    try:
        key.public_key().verify(sig, digest)
        return True
    except p384.SignatureError:
        return False


@pytest.mark.parametrize("d", SCALARS)
def test_pems_equal_cryptography_and_load_both_ways(d):
    ours, theirs = p384.ECDSAP384PrivateKey(d), _theirs(d)
    priv_pem, pub_pem = _their_pems(theirs)
    assert ours.private_bytes_pem() == priv_pem
    assert ours.public_key().public_bytes_pem() == pub_pem
    assert p384.load_pem_private_key(priv_pem).d == d
    assert p384.load_pem_public_key(pub_pem) == ours.public_key()
    loaded = serialization.load_pem_private_key(ours.private_bytes_pem(), password=None)
    assert loaded.private_numbers().private_value == d
    pub = serialization.load_pem_public_key(ours.public_key().public_bytes_pem())
    assert (pub.public_numbers().x, pub.public_numbers().y) == ours.public_key().point


def test_a_pkcs8_key_with_parameters_loads():
    """An ECPrivateKey with its [0] parameters inside PKCS#8 (some writers
    add them) loads; a public key that is not the scalar's raises."""
    d = SCALARS[4]
    inner = p384._enc(0x30, p384._enc(0x02, b"\x01") + p384._enc(0x04, d.to_bytes(48, "big"))
                      + p384._enc(0xA0, p384._enc(0x06, p384.OID_SECP384R1)))
    body = p384._enc(0x30, p384._enc(0x02, b"\x00") + p384._ALGORITHM + p384._enc(0x04, inner))
    pem = p384.pem_encode("PRIVATE KEY", body)
    assert p384.load_pem_private_key(pem).d == d
    assert serialization.load_pem_private_key(pem, None).private_numbers().private_value == d
    other = p384.ECDSAP384PrivateKey(d + 1).pkcs8_der()
    wrong = p384.ECDSAP384PrivateKey(d).pkcs8_der()[:-97] + other[-97:]
    with pytest.raises(X509Error, match="not the private scalar's"):
        p384.load_pem_private_key(p384.pem_encode("PRIVATE KEY", wrong))


@pytest.mark.parametrize("d", SCALARS[:5])
def test_signatures_verify_across_packages(d):
    rng = random.Random(d)
    ours, theirs = p384.ECDSAP384PrivateKey(d), _theirs(d)
    for i in range(3):
        digest = hashlib.sha256(b"cri %d %d" % (d, i)).digest()
        sig = ours.sign(digest, rng)
        assert _their_verdict(theirs, sig, digest) and _our_verdict(ours, sig, digest)
        theirs_sig = theirs.sign(digest, ECDSA)
        assert _our_verdict(ours, theirs_sig, digest)


def test_the_nonce_comes_from_the_generator():
    key = p384.ECDSAP384PrivateKey(SCALARS[3])
    digest = hashlib.sha256(b"epoch").digest()
    assert key.sign(digest, random.Random(9)) == key.sign(digest, random.Random(9))
    assert key.sign(digest, random.Random(9)) != key.sign(digest, random.Random(10))
    assert p384.ECDSAP384PrivateKey.generate(random.Random(4)).d == \
        p384.ECDSAP384PrivateKey.generate(random.Random(4)).d


def _flip(raw: bytes, bit: int) -> bytes:
    out = bytearray(raw)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def test_tampering_is_refused_by_both():
    rng = random.Random(11)
    d = SCALARS[5]
    ours, theirs = p384.ECDSAP384PrivateKey(d), _theirs(d)
    digest = hashlib.sha256(b"prefix").digest()
    sig = ours.sign(digest, rng)
    r, s = der.unmarshal_signature(sig)
    cases = [(_flip(sig, bit), digest) for bit in range(0, len(sig) * 8, 7)]
    cases += [(sig, _flip(digest, bit)) for bit in (0, 77, 255)]
    # the other S: valid under both (no low-S rule for this key)
    cases.append((der.marshal_signature(r, p384.N - s), digest))
    # a non-minimal INTEGER and trailing bytes: not canonical DER
    cases.append((b"\x30" + bytes([sig[1] + 1]) + b"\x02" + bytes([sig[3] + 1]) + b"\x00"
                  + sig[4:], digest))
    cases.append((sig + b"\x00", digest))
    verdicts = []
    for s_bytes, dg in cases:
        want = _their_verdict(theirs, s_bytes, dg)
        assert _our_verdict(ours, s_bytes, dg) == want, (s_bytes.hex(), dg.hex())
        verdicts.append(want)
    assert verdicts[-3] is True and verdicts[-2] is False and verdicts[-1] is False
    assert not any(verdicts[:-3])
    # a signature under another key
    other = p384.ECDSAP384PrivateKey(d + 1).sign(digest, rng)
    assert not _our_verdict(ours, other, digest) and not _their_verdict(theirs, other, digest)


def test_a_digest_that_is_not_sha256_raises():
    key = p384.ECDSAP384PrivateKey(SCALARS[6])
    with pytest.raises(ValueError, match="32 bytes"):
        key.sign(b"\x00" * 48, random.Random(1))
    with pytest.raises(ValueError):
        _theirs(SCALARS[6]).sign(b"\x00" * 48, ECDSA)
