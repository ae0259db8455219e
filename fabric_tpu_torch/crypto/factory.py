"""BCCSP factory: config-driven provider selection (Fabric's
bccsp/factory/factory.go GetBCCSPFromOpts + swfactory/pkcs11factory;
sampleconfig/core.yaml's BCCSP section).

The port's counterpart of the JAX package's `crypto/factory.py`; it reads
the same config shape (the core.yaml BCCSP block, as a dict):

  BCCSP:
    Default: CUDA         # CUDA | SW | PKCS11 | SERVE | a registered rung
                          #  TPU, the JAX package's name and default, is
                          #  read as the same accelerator slot, so a
                          #  core.yaml written for the JAX package builds
                          #  a CUDAProvider
    SW:
      Hash: SHA2
      Security: 256
      # optional tier pins (absent keys leave earlier pins alone):
      # ECBackend: hostec_np | hostec | p256   (fastec is not ported)
      # IdemixBackend: hostbn | scheme
    CUDA:                 # or TPU:; takes no keys (every batch launches
                          #  K2, so the JAX TPU block's MinDeviceBatch
                          #  has no counterpart and is ignored)
    PKCS11:
      Library: /usr/lib/softhsm/libsofthsm2.so
      Pin: "98765432"
      Slot: 0             # optional; first token slot when omitted
    SERVE:                # the serve sidecar rung (serve/client.py)
      Address: /path/to/serve.sock    # or host:port; or instead
      Endpoints: [a.sock, b.sock]     #  a fleet behind SidecarRouter
      QoS: high           # a class, or a map "paychan=high;*=normal"
      Channel: ""
      DeadlineMs: 0       # per-batch wire budget, 0 = none
      HedgeFraction: 0.05 # the router's hedge budget
      HedgeMinMs: 20

PKCS11 errors HARD on a missing library (an operator who configured an
HSM must not silently run on software keys), like Fabric's
pkcs11factory.

Departure from the JAX factory, by design: with no card the accelerator
slot raises FactoryError, as PKCS11 does; it does not degrade to SW
(`fabric_tpu/crypto/factory.py:214-219` does).  ``device="cpu"`` is how a
test asks for the kernels' plain versions on the CPU.  The CUDAProvider
it builds fails closed: a failed build, launch, copy or resolve raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from fabric_tpu_torch.common import flogging
from fabric_tpu_torch.crypto.bccsp import (
    Provider,
    SoftwareProvider,
    ec_backend_name,
    idemix_backend_name,
    select_ec_backend,
    select_idemix_backend,
)
from fabric_tpu_torch.crypto.pkcs11 import Cryptoki, PKCS11Error, PKCS11Provider

logger = flogging.must_get_logger("bccsp.factory")


class FactoryError(Exception):
    pass


class TokenUnavailable(FactoryError, PKCS11Error):
    """The configured Cryptoki library or token could not be opened: a
    FactoryError, and the PKCS11Error the JAX factory raises there."""


# -- pluggable provider rungs (dependency inversion) ------------------------
# Higher-layer packages register their provider builders here instead of
# being imported upward.  _LAZY_PROVIDER_MODULES maps a config Default to
# the module whose import performs that registration.

_PROVIDER_FACTORIES: Dict[str, Callable[[dict], Provider]] = {}
_LAZY_PROVIDER_MODULES: Dict[str, str] = {"SERVE": "fabric_tpu_torch.serve.client"}

# the accelerator slot's names: the port's, then the JAX package's
ACCELERATOR_SLOTS = ("CUDA", "TPU")


def register_provider_factory(
    name: str, builder: Callable[[dict], Provider]
) -> None:
    """Register a config ``Default:`` name -> provider builder (the
    builder receives the full BCCSP config dict)."""
    _PROVIDER_FACTORIES[name.upper()] = builder


def _resolve_provider_factory(name: str) -> Optional[Callable]:
    builder = _PROVIDER_FACTORIES.get(name)
    if builder is not None:
        return builder
    module = _LAZY_PROVIDER_MODULES.get(name)
    if module is None:
        return None
    import importlib

    try:
        importlib.import_module(module)  # import side effect: registers
    except ImportError as exc:
        raise FactoryError(
            f"BCCSP default {name!r} needs {module} which failed to "
            f"import: {exc}"
        ) from exc
    builder = _PROVIDER_FACTORIES.get(name)
    if builder is None:
        raise FactoryError(
            f"{module} imported but did not register a {name!r} provider"
        )
    return builder


def _pin(kind: str, value, select, current_name, tiers: str) -> None:
    """Apply one SW tier pin: a KNOWN tier that cannot load is a hard
    error; an UNKNOWN name logs an error and keeps the current selection
    (a config written for a newer ladder must not brick an older node)."""
    name = str(value).lower()
    try:
        select(name)
    except ValueError:
        logger.error(
            "BCCSP.SW.%s %r is not a known tier (%s); keeping the current "
            "%s backend", kind, name, tiers, current_name(),
        )
    except ImportError as exc:
        raise FactoryError(
            f"BCCSP.SW.{kind} {name!r} unavailable: {exc}"
        ) from exc
    logger.info("BCCSP.SW.%s: %s", kind, current_name())


def _accelerator(device) -> Provider:
    """The accelerator slot: a CUDAProvider on ``device`` (the card when
    None).  No card is a FactoryError."""
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider

    try:
        return CUDAProvider(device="cuda" if device is None else device)
    except (RuntimeError, ValueError) as exc:
        raise FactoryError(f"BCCSP accelerator slot unavailable: {exc}") from exc


def provider_from_config(cfg: Optional[dict], device=None) -> Provider:
    """BCCSP config dict -> Provider instance.  ``device`` places the
    accelerator slot's provider (the card when None; "cpu" for the
    kernels' plain versions)."""
    cfg = cfg or {}
    default = str(cfg.get("Default", "CUDA")).upper()

    sw_cfg = cfg.get("SW") or {}
    hash_family = str(sw_cfg.get("Hash", "SHA2")).upper()
    security = int(sw_cfg.get("Security", 256))
    if hash_family != "SHA2" or security != 256:
        # Fabric's factory rejects unsupported suites outright
        raise FactoryError(
            f"unsupported BCCSP suite {hash_family}-{security} "
            "(only SHA2-256 is implemented)"
        )

    # Host tier pins (crypto/bccsp.py's ladders): process-wide, since
    # every provider's host path shares the seam.  An ABSENT key leaves
    # the selection alone, so building a provider from a plain config
    # cannot reset an earlier explicit pin.
    if "ECBackend" in sw_cfg:
        _pin("ECBackend", sw_cfg["ECBackend"], select_ec_backend,
             ec_backend_name, "hostec_np/hostec/p256")
    if "IdemixBackend" in sw_cfg:
        _pin("IdemixBackend", sw_cfg["IdemixBackend"], select_idemix_backend,
             idemix_backend_name, "hostbn/scheme")

    # Registered rungs first: the tier pins above already applied, so a
    # rung's in-process fallback rides the operator's chosen ladder.
    registered = _resolve_provider_factory(default)
    if registered is not None:
        try:
            return registered(cfg)
        except FactoryError:
            raise
        except Exception as exc:
            raise FactoryError(
                f"BCCSP default {default!r} provider failed to build: {exc}"
            ) from exc

    if default == "SW":
        return SoftwareProvider()
    if default == "PKCS11":
        # HSM slot (bccsp/factory/pkcs11factory.go): a missing or
        # unloadable library is a hard error, exactly like Fabric
        p11 = cfg.get("PKCS11") or {}
        library = p11.get("Library")
        if not library:
            raise FactoryError("BCCSP.PKCS11.Library is required")
        try:
            token = Cryptoki(library, str(p11.get("Pin", "")), p11.get("Slot"))
        except PKCS11Error as exc:
            raise TokenUnavailable(str(exc)) from exc
        return PKCS11Provider(token)
    if default in ACCELERATOR_SLOTS:
        return _accelerator(device)
    raise FactoryError(f"unknown BCCSP default {default!r}")
