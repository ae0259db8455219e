"""The port's BCCSP factory (`crypto/factory.provider_from_config`) against
the JAX package's on the configs of tests/test_pkcs11.py,
tests/test_hostec_np.py and tests/test_hostbn.py::test_factory_idemix_backend:
the same provider kind, the same tier pins, the same error class.

The accelerator slot is the departure: ``Default: CUDA`` (or the JAX
package's ``TPU``) builds a CUDAProvider, configured from the CUDA or TPU
block; with no card it raises FactoryError where the JAX factory builds
its TPUProvider or degrades to SW, and ``device="cpu"`` builds the kernels'
plain versions. `default_provider()` is `provider_from_config(None)` under
a lock. ``fastec`` is a known tier the port never has.
"""

import pytest
import torch

from fabric_tpu.crypto import bccsp as jbccsp
from fabric_tpu.crypto import factory as jfactory
from fabric_tpu.crypto import pkcs11 as jpkcs11
from fabric_tpu_torch.crypto import bccsp, factory, pkcs11
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider

NO_CARD = not torch.cuda.is_available()


@pytest.fixture(autouse=True)
def pins():
    """Every test leaves both packages' tier pins and rung maps as it
    found them."""
    before = (bccsp.ec_backend_name(), bccsp.idemix_backend_name(),
              jbccsp.ec_backend_name(), jbccsp.idemix_backend_name())
    rungs = dict(factory._PROVIDER_FACTORIES), dict(jfactory._PROVIDER_FACTORIES)
    yield
    bccsp.select_ec_backend(before[0])
    bccsp.select_idemix_backend(before[1])
    jbccsp.select_ec_backend(before[2])
    jbccsp.select_idemix_backend(before[3])
    for mod, saved in ((factory, rungs[0]), (jfactory, rungs[1])):
        mod._PROVIDER_FACTORIES.clear()
        mod._PROVIDER_FACTORIES.update(saved)


def _outcome(mod, cfg):
    """(provider class name, EC pin, Idemix pin) or the error's class."""
    try:
        prov = mod.provider_from_config(cfg)
    except Exception as exc:  # noqa: BLE001 - the class is the outcome
        return type(exc).__name__
    b = bccsp if mod is factory else jbccsp
    return type(prov).__name__, b.ec_backend_name(), b.idemix_backend_name()


SAME = {
    "sw": {"Default": "SW"},
    "sw-lowercase": {"Default": "sw", "SW": {"Hash": "sha2", "Security": 256}},
    "ec-hostec_np": {"Default": "SW", "SW": {"ECBackend": "hostec_np"}},
    "ec-hostec": {"Default": "SW", "SW": {"ECBackend": "HOSTEC"}},
    "ec-p256": {"Default": "SW", "SW": {"ECBackend": "p256"}},
    "ec-unknown": {"Default": "SW", "SW": {"ECBackend": "no-such-tier"}},
    "idemix-scheme": {"Default": "SW", "SW": {"IdemixBackend": "scheme"}},
    "idemix-hostbn": {"Default": "SW", "SW": {"IdemixBackend": "hostbn"}},
    "idemix-unknown": {"Default": "SW", "SW": {"IdemixBackend": "hostbn_v99"}},
    "suite-sha3": {"Default": "SW", "SW": {"Hash": "SHA3"}},
    "suite-384": {"Default": "SW", "SW": {"Security": 384}},
    "unknown-default": {"Default": "HSM9000"},
    "pkcs11-no-library": {"Default": "PKCS11", "PKCS11": {}},
    "pkcs11-missing-library": {"Default": "PKCS11",
                               "PKCS11": {"Library": "/nonexistent/libsofthsm2.so"}},
}


@pytest.mark.parametrize("name", list(SAME))
def test_outcome_equals_jax(name):
    """Start both ladders from one pin, so a config that leaves the pin
    alone reads the same in both packages."""
    for b in (bccsp, jbccsp):
        b.select_ec_backend("hostec")
        b.select_idemix_backend("scheme")
    got, want = _outcome(factory, SAME[name]), _outcome(jfactory, SAME[name])
    if name == "pkcs11-missing-library":
        # the port's error is both a FactoryError and the PKCS11Error the
        # JAX factory raises
        assert (got, want) == ("TokenUnavailable", "PKCS11Error")
        with pytest.raises(factory.FactoryError):
            factory.provider_from_config(SAME[name])
        with pytest.raises(pkcs11.PKCS11Error):
            factory.provider_from_config(SAME[name])
        return
    assert got == want
    if name.startswith(("ec-", "idemix-", "sw")):
        assert got[0] == "SoftwareProvider"


def test_pin_absent_keeps_an_earlier_pin():
    factory.provider_from_config({"Default": "SW", "SW": {"ECBackend": "hostec"}})
    factory.provider_from_config({"Default": "SW"})
    assert bccsp.ec_backend_name() == "hostec"
    assert factory.provider_from_config({"Default": "SW"}).describe_backend() == "sw:hostec"


def test_fastec_is_known_and_unavailable():
    """JAX with the cryptography package pins fastec; the port never has
    it: a FactoryError, the pin left where it was."""
    factory.provider_from_config({"Default": "SW", "SW": {"ECBackend": "hostec_np"}})
    with pytest.raises(factory.FactoryError, match="cryptography"):
        factory.provider_from_config({"Default": "SW", "SW": {"ECBackend": "fastec"}})
    assert bccsp.ec_backend_name() == "hostec_np"
    assert "fastec" in bccsp.EC_TIERS


def test_registered_rungs_as_jax():
    built = []
    for mod in (factory, jfactory):
        mod.register_provider_factory("mine", lambda cfg: built.append(cfg) or "built")

        def boom(cfg):
            raise KeyError("nope")

        mod.register_provider_factory("BOOM", boom)
        cfg = {"Default": "MINE", "SW": {"ECBackend": "hostec"}}
        assert mod.provider_from_config(cfg) == "built"
        with pytest.raises(mod.FactoryError, match="failed to build"):
            mod.provider_from_config({"Default": "boom"})
    assert built[0] is not built[1] and built[0] == built[1]
    assert bccsp.ec_backend_name() == jbccsp.ec_backend_name() == "hostec"
    assert factory._LAZY_PROVIDER_MODULES == {"SERVE": "fabric_tpu_torch.serve.client"}


@pytest.mark.parametrize("slot", ["CUDA", "TPU", "cuda"])
def test_accelerator_slot(slot):
    """The slot builds a CUDAProvider, also from a JAX config's TPU block,
    whose keys it ignores (every batch launches K2, so MinDeviceBatch has
    no counterpart); with no card a FactoryError (the JAX factory builds
    its TPUProvider there, or degrades to SW)."""
    block = "TPU" if slot == "TPU" else "CUDA"
    cfg = {"Default": slot, block: {"MinDeviceBatch": 7}}
    prov = factory.provider_from_config(cfg, device="cpu")
    assert isinstance(prov, CUDAProvider)
    assert prov.describe_backend() == "cpu-reference"
    assert isinstance(factory.provider_from_config({"Default": slot}, device="cpu"), CUDAProvider)
    if slot == "TPU":
        jprov = jfactory.provider_from_config(cfg)
        assert type(jprov).__name__ in ("TPUProvider", "SoftwareProvider")
        if type(jprov).__name__ == "TPUProvider":
            assert jprov.MIN_DEVICE_BATCH == 7
    if NO_CARD:
        with pytest.raises(factory.FactoryError, match="no CUDA device"):
            factory.provider_from_config(cfg)


@pytest.mark.skipif(not NO_CARD, reason="the no-card error needs a machine without a card")
def test_default_provider_raises_without_a_card():
    bccsp._default = None
    with pytest.raises(factory.FactoryError):
        bccsp.default_provider()
    assert bccsp._default is None


def test_default_provider_is_built_once(monkeypatch):
    built = []
    monkeypatch.setattr(factory, "provider_from_config",
                        lambda cfg, device=None: built.append(cfg) or object())
    monkeypatch.setattr(bccsp, "_default", None)
    first = bccsp.default_provider()
    assert bccsp.default_provider() is first and built == [None]


def test_pkcs11_missing_library_errors_as_jax():
    with pytest.raises(pkcs11.PKCS11Error):
        pkcs11.Cryptoki("/nonexistent/libsofthsm2.so", "1234")
    with pytest.raises(jpkcs11.PKCS11Error):
        jpkcs11.Cryptoki("/nonexistent/libsofthsm2.so", "1234")
