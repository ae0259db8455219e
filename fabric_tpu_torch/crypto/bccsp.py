"""The BCCSP provider SPI, the host EC and Idemix ladders, and the
software providers.

Shaped after Fabric's provider interface (bccsp/bccsp.go: KeyGen /
KeyImport / Hash / Sign / Verify) plus the batch extension the validator
feeds: ``batch_verify``. The verify decision is Fabric's verifyECDSA
(bccsp/sw/ecdsa.go:41-57): DER unmarshal, then the low-S rule, then the
curve equation.

The port's counterpart of the JAX package's `crypto/bccsp.py`, with the
same names:

- the host EC ladder ``hostec_np`` (numpy limb matrices, shared-memory
  shards) -> ``hostec`` (vectorized pure Python, sharded across cores) ->
  ``p256`` (the oracle; explicit selection only). ``fastec``, the JAX
  ladder's OpenSSL rung, needs the ``cryptography`` package and is not
  ported: it stays a known tier name that is never available, so a pin
  of it raises ImportError and the auto walk passes it by. Select with
  BCCSP.SW.ECBackend (`crypto/factory`) or `select_ec_backend()`.
- the Idemix ladder ``hostbn`` -> ``scheme``, the rung that
  `idemix/batch.verify_signatures_batch` runs when a caller asks for
  the host route (its default route is the device).
- `SoftwareProvider`, the host provider over the active EC tier, with
  the ``bccsp.dispatch`` fault point and the ``bccsp.verdict`` corrupt
  seam; `PurePythonProvider`, the oracle behind the same SPI.
- `CUDAProvider` (`crypto/cuda_provider`): the same decision function,
  the curve math in the hand-written kernels; `probe_provider` builds it
  for the serve sidecar and its clients' rescue.
"""

from __future__ import annotations

import hashlib
import secrets
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import der, fabobs, p256
from fabric_tpu_torch.common.faults import corrupt_verdicts, fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.crypto import hostec
from fabric_tpu_torch.utils import native

logger = must_get_logger("bccsp")

# ---------------------------------------------------------------------------
# Host EC backend ladder: hostec_np (numpy limb-matrix lanes) -> hostec
# (vectorized pure Python) -> p256 (clarity-first oracle).  All tiers
# share one semantics contract (Go crypto/ecdsa.Verify decision, low-S
# pre-checked by callers via parse_and_precheck).  The oracle is never
# auto-selected.
# ---------------------------------------------------------------------------

EC_TIERS = ("fastec", "hostec_np", "hostec", "p256")


def _load_ec_backend(name: str):
    """Backend module by tier name; raises ImportError/ValueError."""
    if name == "fastec":
        raise ImportError(
            "fastec needs the cryptography package, which the port does "
            "not use"
        )
    if name == "hostec_np":
        from fabric_tpu_torch.crypto import hostec_np

        if not hostec_np.HAVE_NUMPY:
            raise ImportError("hostec_np requires numpy")
        return hostec_np
    if name == "hostec":
        return hostec
    if name == "p256":
        return p256
    raise ValueError(
        f"unknown EC backend {name!r} (expected one of {EC_TIERS})"
    )


def available_ec_backends():
    """Tier name -> importable right now. hostec and p256 are pure Python
    and always available; hostec_np needs numpy; fastec never is."""
    out = {}
    for name in EC_TIERS:
        try:
            _load_ec_backend(name)
            out[name] = True
        except ImportError:
            out[name] = False
    return out


def select_ec_backend(name: str = "auto"):
    """Select the process-wide scalar/batch EC backend and return it.

    ``auto`` walks the ladder hostec_np -> hostec (the oracle is never
    an auto choice) — asking for ``auto`` NEVER raises.  An
    explicitly named unavailable tier raises ImportError so a configured
    expectation is never silently downgraded."""
    global _ec
    name = str(name or "auto").lower()
    if name != "auto":
        _ec = _load_ec_backend(name)
        return _ec
    for tier in ("fastec", "hostec_np"):
        try:
            _ec = _load_ec_backend(tier)
            return _ec
        except ImportError as exc:
            # loudly-in-the-log, silently-for-callers: a rung is skipped
            # only here, on the auto walk
            if tier == "hostec_np":
                logger.warning(
                    "hostec_np tier skipped (%s); walking down to hostec", exc
                )
            else:
                logger.debug("%s tier skipped (%s)", tier, exc)
            continue
    _ec = hostec
    return _ec


def ec_backend():
    """The active scalar-EC module: ``hostec_np`` when numpy is there,
    else ``hostec``; the ``p256`` oracle only on explicit selection."""
    return _ec


def ec_backend_name() -> str:
    """Short tier name of the active backend (``hostec_np``/``hostec``/
    ``p256``)."""
    return _ec.__name__.rsplit(".", 1)[-1]


def ec_pool_ready() -> bool:
    """Health view of the active EC tier's process pool: False while a
    broken pool's rebuild cooldown is open (verifies still serve, but
    inline).  Tiers without a pool gate are trivially ready."""
    gate = getattr(_ec, "_POOL_GATE", None)
    if gate is None:
        return True
    try:
        return bool(gate.ready())
    except Exception as exc:  # noqa: BLE001 - health probe must not raise
        logger.debug("ec pool gate probe failed (%s); reporting ready", exc)
        return True


# Import-time init: select_ec_backend("auto") never raises.
_ec = select_ec_backend("auto")


# ---------------------------------------------------------------------------
# Idemix verify backend ladder: hostbn (numpy limb-matrix FP256BN pairing
# lanes, crypto/hostbn.py) -> scheme (the per-signature idemix/scheme.py
# oracle).  The "scheme" rung is a SENTINEL (None): idemix/batch.py owns
# the oracle loop.
# ---------------------------------------------------------------------------

IDEMIX_TIERS = ("hostbn", "scheme")


def _load_idemix_backend(name: str):
    """Backend module by tier name (None for the scheme-oracle rung);
    raises ImportError/ValueError like _load_ec_backend."""
    if name == "hostbn":
        from fabric_tpu_torch.crypto import hostbn

        if not hostbn.HAVE_NUMPY:
            raise ImportError("hostbn requires numpy")
        return hostbn
    if name == "scheme":
        return None
    raise ValueError(
        f"unknown idemix backend {name!r} (expected one of {IDEMIX_TIERS})"
    )


def available_idemix_backends():
    """Tier name -> usable right now (hostbn needs numpy; the scheme
    oracle is always available)."""
    out = {}
    for name in IDEMIX_TIERS:
        try:
            _load_idemix_backend(name)
            out[name] = True
        except ImportError:
            out[name] = False
    return out


def select_idemix_backend(name: str = "auto"):
    """Select the process-wide Idemix host rung and return its module
    (None = the scheme oracle).  ``auto`` walks hostbn -> scheme —
    asking for ``auto`` NEVER raises.  An
    explicitly named unavailable tier raises ImportError."""
    global _idemix, _idemix_name
    name = str(name or "auto").lower()
    if name != "auto":
        _idemix = _load_idemix_backend(name)
        _idemix_name = name
        return _idemix
    try:
        _idemix = _load_idemix_backend("hostbn")
        _idemix_name = "hostbn"
    except ImportError:
        logger.warning(
            "hostbn idemix tier skipped (numpy not installed); "
            "falling back to the scheme oracle rung"
        )
        _idemix = None
        _idemix_name = "scheme"
    return _idemix


def idemix_backend():
    """The active Idemix host rung module (crypto/hostbn), or None when
    the scheme-oracle rung is active."""
    return _idemix


def idemix_backend_name() -> str:
    """Short tier name of the active Idemix rung (``hostbn``/``scheme``):
    what a caller asking `verify_signatures_batch` for the host route
    passes as its ``backend``."""
    return _idemix_name


_idemix = None
_idemix_name = "scheme"
_idemix = select_idemix_backend("auto")


@dataclass(frozen=True)
class ECDSAPublicKey:
    """An imported P-256 public key."""

    x: int
    y: int

    @property
    def point(self) -> Tuple[int, int]:
        return (self.x, self.y)

    def ski(self) -> bytes:
        """Subject Key Identifier: SHA-256 of the uncompressed point
        (bccsp/sw/ecdsakey.go SKI)."""
        return hashlib.sha256(p256.pubkey_to_bytes(self.point)).digest()


@dataclass(frozen=True)
class ECDSAPrivateKey:
    d: int
    public: ECDSAPublicKey


class VerifyError(Exception):
    """Verification *errors* (vs. a clean False), mirroring Fabric's
    (bool, error) split: malformed DER and high-S return an error, a failed
    curve equation returns (false, nil)."""


class Provider:
    """SPI. Verify semantics contract (bccsp/sw/ecdsa.go verifyECDSA):

    - signature fails DER unmarshal or has non-positive R/S -> VerifyError
    - S > N/2 (not low-S)                                   -> VerifyError
    - otherwise                                             -> bool
    """

    def hash(self, msg: bytes) -> bytes:
        return hashlib.sha256(msg).digest()

    def batch_hash(self, msgs: Sequence[bytes]) -> List[bytes]:
        """One digest per message, through the native library's batched
        SHA-256; equal to [self.hash(m) for m in msgs]."""
        return [bytes(d) for d in native.batch_sha256(msgs)]

    def key_import(self, raw: bytes) -> ECDSAPublicKey:
        x, y = p256.pubkey_from_bytes(raw)
        return ECDSAPublicKey(x, y)

    def key_gen(self) -> ECDSAPrivateKey:
        kp = _ec.generate_keypair()
        return ECDSAPrivateKey(kp.priv, ECDSAPublicKey(*kp.pub))

    def sign(self, key: ECDSAPrivateKey, digest: bytes) -> bytes:
        r, s = _ec.sign_digest(key.d, digest)
        return der.marshal_signature(r, s)

    def verify(self, key: ECDSAPublicKey, signature: bytes, digest: bytes) -> bool:
        raise NotImplementedError

    def batch_verify(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ) -> List[bool]:
        """Batched verification; host parse/low-S failures map to False."""
        out = []
        for k, sig, d in zip(keys, signatures, digests, strict=True):
            try:
                out.append(self.verify(k, sig, d))
            except VerifyError:
                out.append(False)
        return out

    def describe_backend(self) -> str:
        """Short label of the execution path batches actually take."""
        return type(self).__name__


def parse_and_precheck(signature: bytes) -> Tuple[int, int]:
    """Host-side DER unmarshal + low-S gate.

    Raises VerifyError exactly where Fabric returns an error.
    """
    try:
        r, s = der.unmarshal_signature(signature)
    except der.DerError as e:
        raise VerifyError(f"failed unmarshalling signature [{e}]") from e
    if not p256.is_low_s(s):
        raise VerifyError("invalid S, must be smaller than half the order")
    return r, s


class SoftwareProvider(Provider):
    """Host provider riding the active EC backend tier: DER parse + low-S
    gate in Python, then the curve math on hostec_np (numpy limb
    matrices, shards over a process pool) or hostec (vectorized pure
    Python)."""

    def verify(self, key: ECDSAPublicKey, signature: bytes, digest: bytes) -> bool:
        r, s = parse_and_precheck(signature)
        return _ec.verify_digest(key.point, digest, r, s)

    def describe_backend(self) -> str:
        return f"sw:{ec_backend_name()}"

    def _parse_lanes(self, keys, signatures, digests):
        """(pub, digest, r, s) lanes for the vectorized engines; parse and
        low-S failures become r = s = 0 (an always-False lane)."""
        lanes = []
        for k, sig, d in zip(keys, signatures, digests, strict=True):
            try:
                r, s = parse_and_precheck(sig)
            except VerifyError:
                r, s = 0, 0
            lanes.append((k.point if k is not None else None, d, r, s))
        return lanes

    @staticmethod
    def _chaos_verdicts(out: List[bool]) -> List[bool]:
        """``bccsp.verdict`` corrupt seam: only an installed fault plan can
        reach the flip — it exists so a bit-exact mask assertion can be
        shown to CATCH a corrupted mask.  It fires once a batch_verify or
        a resolve, in this process, never in a shard worker."""
        spec = fault_point("bccsp.verdict", interprets=("corrupt",))
        if spec is not None and spec.action == "corrupt":
            return corrupt_verdicts(out, spec)
        return out

    def batch_verify(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ) -> List[bool]:
        # unkeyed: batch sizes are static in steady state, so a content
        # key would turn a probabilistic plan into all-or-nothing
        fault_point("bccsp.dispatch")
        rung = ec_backend_name()
        t0 = time.perf_counter()
        with fabobs.span("bccsp.batch_verify", rung=rung, lanes=len(keys)):
            sharded = getattr(_ec, "verify_parsed_batch_sharded", None)
            if sharded is None:
                out = super().batch_verify(keys, signatures, digests)
            else:
                out = sharded(self._parse_lanes(keys, signatures, digests))()
        fabobs.obs_count("fabric_verify_lanes_total", len(keys), rung=rung)
        fabobs.obs_observe(
            "fabric_verify_seconds", time.perf_counter() - t0, rung=rung
        )
        return self._chaos_verdicts(list(out))

    def batch_verify_async(self, keys, signatures, digests):
        """Resolver-style dispatch (the VerifyBatcher/validator seam): on
        the hostec/hostec_np tiers the batch is sharded across the process
        pool and the resolver joins the shards (order-preserving),
        overlapping any host work the caller does before resolving.  The
        oracle tier computes synchronously and hands back a trivial
        resolver."""
        fault_point("bccsp.dispatch")
        rung = ec_backend_name()
        t0 = time.perf_counter()
        sharded = getattr(_ec, "verify_parsed_batch_sharded", None)
        if sharded is None:
            out = Provider.batch_verify(self, keys, signatures, digests)
            inner = lambda v=out: v  # noqa: E731
        else:
            inner = sharded(self._parse_lanes(keys, signatures, digests))
        n = len(keys)

        def resolve() -> List[bool]:
            # latency spans dispatch -> resolve: the window a caller
            # actually waits on this rung, pool shards included
            verdicts = self._chaos_verdicts(list(inner()))
            fabobs.obs_count("fabric_verify_lanes_total", n, rung=rung)
            fabobs.obs_observe(
                "fabric_verify_seconds", time.perf_counter() - t0, rung=rung
            )
            return verdicts

        return resolve


class PurePythonProvider(SoftwareProvider):
    """The clarity-first big-int oracle.  Differential tests ONLY — never
    a default path.  Pins the p256 module regardless of the active
    backend tier (it IS the oracle the other tiers are held to)."""

    def verify(self, key: ECDSAPublicKey, signature: bytes, digest: bytes) -> bool:
        r, s = parse_and_precheck(signature)
        return p256.verify_digest(key.point, digest, r, s)

    def describe_backend(self) -> str:
        return "sw:p256"

    def batch_verify(self, keys, signatures, digests) -> List[bool]:
        return Provider.batch_verify(self, keys, signatures, digests)

    def batch_verify_async(self, keys, signatures, digests):
        out = Provider.batch_verify(self, keys, signatures, digests)
        return lambda: out

    def sign(self, key: ECDSAPrivateKey, digest: bytes) -> bytes:
        # the oracle's signer takes its nonce from the caller
        r, s = p256.sign_digest(key.d, digest, secrets.randbelow(p256.N - 1) + 1)
        return der.marshal_signature(r, s)

    def key_gen(self) -> ECDSAPrivateKey:
        d = secrets.randbelow(p256.N - 1) + 1
        return ECDSAPrivateKey(d, ECDSAPublicKey(*p256.base_mult(d)))


_default: Optional[Provider] = None
# two channels starting concurrently must not both construct a provider:
# a CUDAProvider holds device state, and the loser's would be wasted
_default_lock = threading.Lock()


def default_provider() -> Provider:
    """The provider the BCCSP factory builds from no configuration
    (`factory.provider_from_config(None)`: the accelerator slot), built
    once under a lock.  With no card that is a FactoryError: the port
    never degrades to the software provider by itself."""
    global _default
    with _default_lock:
        if _default is None:
            from fabric_tpu_torch.crypto.factory import provider_from_config

            _default = provider_from_config(None)
        return _default


def probe_provider(device=None) -> Provider:
    """The device provider, independent of any sidecar routing: a
    `CUDAProvider` on the card (or on ``device``; ``"cpu"`` for the
    kernels' plain versions).  The serve sidecar's ``auto`` and
    ``device`` engines and its clients' rescue are built here.

    Departure from the JAX probe (`fabric_tpu/crypto/bccsp.py:551-573`),
    which lands on `SoftwareProvider` when no device answers: with no
    card this raises `FactoryError`, so no serve path lands on the CPU
    because the card is missing."""
    from fabric_tpu_torch.crypto.factory import _accelerator

    return _accelerator(device)
