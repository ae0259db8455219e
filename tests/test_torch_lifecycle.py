"""The port's `_lifecycle` (lifecycle.LifecycleResources) and the definition
sources of the validator (dispatcher.LifecycleRegistry, legacy.LSCCRegistry,
legacy.ValidationRouter) against the JAX package's.

tests/test_lifecycle.py's flows run in both packages side by side over
dict-backed state: every outcome (a definition, a readiness map, an error
string) is equal, and so are the bytes each package writes under every
`_lifecycle` key and every org's approval key. Then the registries resolve
equal definitions (name, the policy's bytes, the plugin) from that state, and
from LSCC records, by the channel's capabilities."""

import pytest

from fabric_tpu import lifecycle as jlc
from fabric_tpu.policy import from_dsl as jdsl
from fabric_tpu.policy.proto_convert import marshal_application_policy as jmarshal_app
from fabric_tpu.policy.proto_convert import marshal_envelope as jmarshal
from fabric_tpu.protos import peer_pb2
from fabric_tpu.validation import dispatcher as jdisp
from fabric_tpu.validation import legacy as jleg
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch import lifecycle as tlc
from fabric_tpu_torch.policy.ast import from_dsl as tdsl
from fabric_tpu_torch.policy.proto_convert import marshal_application_policy as tmarshal_app
from fabric_tpu_torch.policy.proto_convert import marshal_envelope as tmarshal
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.validation import dispatcher as tdisp
from fabric_tpu_torch.validation import legacy as tleg
from fabric_tpu_torch.validation import validator as tval

ORGS = ["Org1", "Org2", "Org3"]
POLICY = "OutOf(2,'Org1MSP.member','Org2MSP.member','Org3MSP.member')"


class Side:
    """One package's LifecycleResources over dict-backed public and org
    state."""

    def __init__(self, mod):
        self.mod = mod
        self.pub, self.orgs = {}, {}
        self.res = mod.LifecycleResources(
            self.pub.get, self.pub.__setitem__,
            lambda o, k: self.orgs.get((o, k)),
            lambda o, k, v: self.orgs.__setitem__((o, k), v), ORGS)

    def run(self, method, *args, **kw):
        """The call's result, or ("error", type name, message)."""
        args = [self.mod.ChaincodeDefinition(**a) if isinstance(a, dict) else a for a in args]
        try:
            return getattr(self.res, method)(*args, **kw)
        except Exception as exc:  # noqa: BLE001 - compared across packages
            return ("error", type(exc).__name__, str(exc))


def both(steps):
    """Run `steps` ((method, *args)) in both packages; every outcome and the
    final state bytes equal. Returns the port's side and the outcomes."""
    sides = [Side(jlc), Side(tlc)]
    outcomes = []
    for method, *args in steps:
        got = [s.run(method, *args) for s in sides]
        assert repr(got[0]) == repr(got[1]).replace("fabric_tpu_torch", "fabric_tpu"), method
        outcomes.append(got[1])
    assert sides[0].pub == sides[1].pub and sides[0].orgs == sides[1].orgs
    return sides[1], outcomes


CD1 = {"sequence": 1, "validation_parameter": b"pol"}


def test_approve_then_commit_majority_same_state():
    side, out = both([
        ("approve_chaincode_definition_for_org", "Org1", "cc", CD1, "pkg1"),
        ("check_commit_readiness", "cc", CD1),
        ("commit_chaincode_definition", "cc", CD1),
        ("approve_chaincode_definition_for_org", "Org2", "cc", CD1),
        ("commit_chaincode_definition", "cc", CD1),
        ("current_sequence", "cc"),
        ("validation_info", "cc"),
        ("query_chaincode_definition", "cc"),
    ])
    assert out[1] == {"Org1": True, "Org2": False, "Org3": False}
    assert out[2][0] == "error"
    assert out[4] == {"Org1": True, "Org2": True, "Org3": False}
    assert out[5] == 1 and out[6] == ("vscc", b"pol")
    # the state keys of the reference's serializer, 8 of them
    assert sorted(side.pub) == sorted(
        ["namespaces/metadata/cc"] + [f"namespaces/fields/cc/{f}" for f in (
            "Sequence", "Version", "EndorsementPlugin", "ValidationPlugin",
            "ValidationParameter", "Collections", "InitRequired")])


def test_sequence_and_parameter_rules_same_errors():
    cd3 = {"sequence": 3}
    a = {"sequence": 1, "validation_parameter": b"a"}
    b = {"sequence": 1, "validation_parameter": b"b"}
    _, out = both([
        ("approve_chaincode_definition_for_org", "Org1", "cc", cd3),
        ("check_commit_readiness", "cc", cd3),
        ("approve_chaincode_definition_for_org", "Org1", "cc", a),
        ("approve_chaincode_definition_for_org", "Org2", "cc", b),
        ("check_commit_readiness", "cc", a),
    ])
    assert out[0][0] == out[1][0] == "error"
    assert out[4] == {"Org1": True, "Org2": False, "Org3": False}


def test_upgrade_sequence_same_state():
    cd1 = {"sequence": 1}
    cd2 = {"sequence": 2, "version": "2.0", "validation_plugin": "guard",
           "collections": b"\x0a\x00", "init_required": True}
    _, out = both([
        ("approve_chaincode_definition_for_org", "Org1", "cc", cd1),
        ("approve_chaincode_definition_for_org", "Org2", "cc", cd1),
        ("commit_chaincode_definition", "cc", cd1),
        ("approve_chaincode_definition_for_org", "Org3", "cc", cd1),
        ("approve_chaincode_definition_for_org", "Org3", "cc", {"sequence": 1, "version": "2.0"}),
        ("approve_chaincode_definition_for_org", "Org2", "cc", cd2),
        ("approve_chaincode_definition_for_org", "Org3", "cc", cd2, "pkg2"),
        ("commit_chaincode_definition", "cc", cd2),
        ("current_sequence", "cc"),
        ("query_chaincode_definition", "cc"),
        ("query_chaincode_definition", "nope"),
        ("validation_info", "nope"),
        ("current_sequence", "nope"),
    ])
    assert out[4][0] == "error"
    assert out[8] == 2 and out[9].version == "2.0" and out[9].init_required
    assert out[10] is None and out[11] is None and out[12] == 0


def _committed_state(mod, marshal_app, dsl, collections=b"", plugin="vscc"):
    """(ns, key) -> bytes: benchcc's committed definition written by `mod`'s
    LifecycleResources under `_lifecycle`, and two LSCC records."""
    side = Side(mod)
    cd = {"sequence": 1, "validation_plugin": plugin,
          "validation_parameter": marshal_app(dsl(POLICY)), "collections": collections}
    for org in ORGS[:2]:
        side.run("approve_chaincode_definition_for_org", org, "benchcc", cd)
    side.run("commit_chaincode_definition", "benchcc", cd)
    table = {(mod.NAMESPACE, k): v for k, v in side.pub.items()}
    table[(mod.NAMESPACE, "namespaces/metadata/badcc")] = b"x"
    table[(mod.NAMESPACE, "namespaces/fields/badcc/Sequence")] = wire.encode(
        fabric.STATE_DATA, {"Int64": 1})
    table[(mod.NAMESPACE, "namespaces/fields/badcc/ValidationParameter")] = wire.encode(
        fabric.STATE_DATA, {"Bytes": b"\x12\x03abc"})  # a channel config policy reference
    for name, vscc in (("oldcc", "vscc"), ("oldplug", "oldguard")):
        data = peer_pb2.ChaincodeData(name=name, version="1.0", vscc=vscc,
                                      policy=jmarshal(jdsl("OR('Org1MSP.member')")))
        table[("lscc", name)] = data.SerializeToString()
    table[("lscc", "brokencc")] = b"\xff\xfe"
    return table


def _definition(d, marshal):
    return None if d is None else (d.name, marshal(d.endorsement_policy), d.plugin)


@pytest.mark.parametrize("plugin", ["vscc", "guard", ""])
def test_registries_resolve_equal_definitions(plugin):
    """LifecycleRegistry (lifecycle first, legacy fallback), LSCCRegistry and
    ValidationRouter resolve equal definitions from the state each package's
    LifecycleResources wrote, which is itself equal byte for byte."""
    jstate = _committed_state(jlc, jmarshal_app, jdsl, plugin=plugin)
    tstate = _committed_state(tlc, tmarshal_app, tdsl, plugin=plugin)
    assert jstate == tstate
    names = ("benchcc", "badcc", "oldcc", "oldplug", "brokencc", "ghost")
    results = {}
    for caps in (["V2_0"], ["V1_4_2"]):
        for plugins in (False, True):
            side = []
            for disp, leg, val, marshal, state in (
                    (jdisp, jleg, jval, jmarshal, jstate), (tdisp, tleg, tval, tmarshal, tstate)):
                get = lambda ns, key, state=state: state.get((ns, key))  # noqa: E731
                registry = disp.PluginRegistry()
                if plugins:
                    registry.register("guard", object())
                lscc = leg.LSCCRegistry(get)
                life = disp.LifecycleRegistry(get, legacy=lscc, plugin_registry=registry)
                router = leg.ValidationRouter(life, lscc, lambda caps=caps: caps)
                side.append({name: (_definition(life.get(name), marshal),
                                    _definition(lscc.get(name), marshal),
                                    _definition(router.get(name), marshal), router.v20_active)
                             for name in names})
            assert side[0] == side[1]
            results[(caps[0], plugins)] = side[1]
    v20 = results[("V2_0", True)]
    assert v20["benchcc"][0][2] == (plugin or "builtin")
    assert v20["oldcc"][0] == v20["oldcc"][1] is not None  # the legacy fallback
    assert v20["brokencc"][1] is None and v20["ghost"][0] is None
    assert v20["badcc"][0] is None  # a policy reference, not a signature policy
    if plugin == "guard":
        assert results[("V2_0", False)]["benchcc"][0] is None  # the plugin is missing
    assert results[("V1_4_2", True)]["benchcc"][2] is None  # legacy channels read LSCC
