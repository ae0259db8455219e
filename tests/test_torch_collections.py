"""The port's private-data collections (ledger/collections) and the legacy
collection-config rules (validation/legacy) against the JAX package's.

Packages built by both `build_collection_config_package`s serialize to the
same bytes; CollectionAccess reads the same fields and gives the same
`is_member` over config #2's MSPs (chip_smoke.Config2Net, each package's MSP
over the same certificates); a CollectionStore's `btl_policy` drives the
private-data store's purge at BTL 1 and 2 on tests/test_torch_kvledger.py's
seeded chain, with `.pvtdata`, SQLite rows and the stored private data equal
to the JAX ledger's; and `validate_collection_config_package` and the v12/v13
write-set guards return the same error string for every case, an upgrade
that modifies one collection and packages that carry unknown fields (which
protobuf keeps and serializes after the known ones) included."""

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.ledger import collections as jcol
from fabric_tpu.ledger import kvledger as jkv
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.protos import collection_pb2
from fabric_tpu.validation import legacy as jleg
from fabric_tpu_torch.ledger import collections as tcol
from fabric_tpu_torch.ledger import kvledger as tkv
from fabric_tpu_torch.ledger import rwset as trw
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.validation import legacy as tleg
from test_torch_kvledger import CC, COLL, commit_jax, commit_port, rows, world  # noqa: F401

SPECS = [
    [{"name": "c1", "policy": "OR('Org1MSP.member','Org2MSP.member')", "block_to_live": 3,
      "member_only_read": True}],
    [{"name": "c1", "policy": "OutOf(2,'Org1MSP.member','Org2MSP.member','Org3MSP.member')",
      "required_peer_count": 1, "maximum_peer_count": 2, "member_only_write": True},
     {"name": "c2", "policy": "OR('Org3MSP.peer')", "block_to_live": 1 << 40}],
    [{"name": "nopolicy"}],
    [],
]


def both_packages(spec):
    return (jcol.build_collection_config_package(spec).SerializeToString(),
            wire.encode(fabric.COLLECTION_CONFIG_PACKAGE, tcol.build_collection_config_package(spec)))


@pytest.mark.parametrize("spec", SPECS, ids=["one", "two", "no-policy", "empty"])
def test_packages_equal_byte_for_byte(spec):
    jraw, traw = both_packages(spec)
    assert jraw == traw
    # and both stores read back the same collections from those bytes
    jstore, tstore = jcol.CollectionStore(lambda ns: jraw), tcol.CollectionStore(lambda ns: traw)
    for c in spec + [{"name": "ghost"}]:
        name = c["name"]
        assert jstore.has_collection("cc", name) == tstore.has_collection("cc", name)
        assert jstore.btl_policy()("cc", name) == tstore.btl_policy()("cc", name)


def _fields(access):
    return (access.name, access.required_peer_count, access.maximum_peer_count,
            access.block_to_live, access.member_only_read, access.member_only_write)


def test_collection_access_and_membership_over_config2_msps():
    import chip_smoke
    from fabric_tpu.crypto.bccsp import SoftwareProvider
    from fabric_tpu.msp import identity as jid
    from fabric_tpu_torch.msp.signer import SigningIdentity

    net = chip_smoke.Config2Net(seed=77)
    sw = SoftwareProvider()
    jmgr = jid.MSPManager([
        jid.MSP(jid.MSPConfig(c.msp_id, c.root_certs, admins=c.admins,
                              revocation_list=c.revocation_list,
                              node_ous=jid.NodeOUs(enable=c.node_ous.enable)), provider=sw)
        for c in net.msp_configs()])
    tmgr = net.managers[False]
    members = [net.client.serialize(), *(e.serialize() for e in net.endorsers),
               SigningIdentity(net.orgs[2].peers[0], net.rng).serialize(),
               SigningIdentity(net.orgs[2].users[0], net.rng).serialize()]
    jraw, traw = both_packages(SPECS[1] + SPECS[2])
    seen = []
    for name in ("c1", "c2", "nopolicy"):
        ja = jcol.CollectionStore(lambda ns: jraw).collection("cc", name)
        ta = tcol.CollectionStore(lambda ns: traw).collection("cc", name)
        assert _fields(ja) == _fields(ta)
        for raw in members:
            jident, jmsp = jmgr.deserialize_identity(raw)
            tident, tmsp = tmgr.deserialize_identity(raw)
            got = ta.is_member(tident, tmsp)
            assert got == ja.is_member(jident, jmsp)
            seen.append(got)
    assert True in seen and False in seen
    with pytest.raises(tcol.NoSuchCollectionError, match="collection cc/ghost not found"):
        tcol.CollectionStore(lambda ns: traw).collection("cc", "ghost")


@pytest.mark.parametrize("btl", [1, 2])
def test_btl_policy_purges_as_jax(world, tmp_path, btl):  # noqa: F811
    """The seeded chain's collection with BTL 1 and 2 through both ledgers,
    each with its own CollectionStore over its own package bytes."""
    spec = [{"name": COLL, "policy": "OR('Org1MSP.member')", "block_to_live": btl}]
    jraw, traw = both_packages(spec)
    assert jraw == traw
    jledger = jkv.KVLedger(str(tmp_path / "jax"), "benchchan",
                           btl_policy=jcol.CollectionStore(lambda ns: jraw).btl_policy())
    tledger = tkv.KVLedger(str(tmp_path / "port"), "benchchan",
                           btl_policy=tcol.CollectionStore(lambda ns: traw).btl_policy())
    try:
        assert commit_port(tledger, world["blocks"]) == commit_jax(None, world["blocks"],
                                                                  ledger=jledger)
        stored = []
        for b in range(len(world["blocks"])):
            want = [(e.tx_num, e.namespace, e.collection, e.rwset)
                    for e in jledger.pvt_store.get_pvt_data_by_block(b)]
            got = [(e.tx_num, e.namespace, e.collection, e.rwset)
                   for e in tledger.pvt_store.get_pvt_data_by_block(b)]
            assert got == want
            stored.append(len(got))
        assert (tledger.pvt_store.get_missing_pvt_data().keys()
                == jledger.pvt_store.get_missing_pvt_data().keys())
    finally:
        jledger.close()
        tledger.close()
    # the blocks older than the BTL lost their private data, the last kept it
    assert stored[0] == 0 and stored[-1] > 0
    for suffix in (".chain", ".pvtdata"):
        assert ((tmp_path / "port" / f"benchchan{suffix}").read_bytes()
                == (tmp_path / "jax" / f"benchchan{suffix}").read_bytes())
    assert rows(tmp_path / "port") == rows(tmp_path / "jax")


def _tag(number: int, wire_type: int) -> bytes:
    v, out = number << 3 | wire_type, bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _len(number: int, body: bytes) -> bytes:
    return _tag(number, 2) + bytes([len(body)]) + body


def _package(*statics: bytes, extra: bytes = b"") -> bytes:
    """A package of collections given as StaticCollectionConfig bytes."""
    return b"".join(_len(1, _len(1, s)) for s in statics) + extra


def _static(spec: dict) -> bytes:
    return collection_pb2.CollectionConfigPackage.FromString(
        both_packages([spec])[0]).config[0].static_collection_config.SerializeToString()


C1 = {"name": "c1", "policy": "OR('Org1MSP.member')"}
C2 = {"name": "c2", "policy": "OR('Org1MSP.member')"}
UNKNOWN = _tag(20, 0) + b"\x05"  # an unknown varint field, number 20
NAME_C1 = _len(1, b"c1")


def _cases():
    """[(id, raw package, committed package or None)]."""
    pkg = lambda *specs: both_packages(list(specs))[0]  # noqa: E731
    c1, c2 = _static(C1), _static(C2)
    rest_c1 = c1[len(NAME_C1):]  # c1's fields after its name
    identity_principal = _len(2, _tag(1, 0) + b"\x01" + _len(2, b"x"))  # no rule
    policy_unknown = wire.decode(fabric.STATIC_COLLECTION_CONFIG, c1)
    policy_unknown["member_orgs_policy"]["signature_policy"][wire.UNKNOWN] = UNKNOWN
    c1_policy_unknown = wire.encode(fabric.STATIC_COLLECTION_CONFIG, policy_unknown)
    ou_policy = _len(2, _len(1, _tag(2, 0) + b"\x01") + _len(3, _tag(1, 0) + b"\x07"))
    return [
        ("valid", pkg(C1), None),
        ("valid-two", pkg(C1, C2), None),
        ("malformed", b"\xff\xfe\xfd", None),
        ("not-utf8-name", _package(_len(1, b"\xff")), None),
        ("empty", b"", None),
        ("no-payload", _len(1, b""), None),
        ("unknown-payload-member", _len(1, _len(2, b"")), None),
        ("empty-name", pkg({"name": "", "policy": "OR('Org1MSP.member')"}), None),
        ("duplicate", pkg(C1, C1), None),
        ("peer-counts", pkg({**C1, "required_peer_count": 3, "maximum_peer_count": 1}), None),
        ("no-member-policy", pkg({"name": "c"}), None),
        ("policy-without-identities", _package(NAME_C1 + _len(2, _len(1, b""))), None),
        ("unsupported-principal", _package(NAME_C1 + _len(2, _len(1, ou_policy))), None),
        ("identity-principal", _package(NAME_C1 + _len(2, _len(1, identity_principal))), None),
        ("grown", pkg(C1, C2), pkg(C1)),
        ("dropped", pkg(C2), pkg(C1)),
        ("modified", pkg({"name": "c1", "policy": "OR('Org2MSP.member')"}, C2), pkg(C1, C2)),
        ("modified-btl", pkg({**C1, "block_to_live": 9}), pkg(C1)),
        ("unreadable-committed", pkg(C1), b"\xff\xfe"),
        # unknown fields: kept and written after the known ones, as protobuf does
        ("unknown-in-new-only", _package(c1 + UNKNOWN), pkg(C1)),
        ("unknown-in-both", _package(c1 + UNKNOWN, c2), _package(c1 + UNKNOWN)),
        ("unknown-reordered", _package(UNKNOWN + c1), _package(c1 + UNKNOWN)),
        ("known-reordered", _package(rest_c1 + NAME_C1), pkg(C1)),
        ("unknown-before-name", _package(UNKNOWN + NAME_C1 + rest_c1 + UNKNOWN), _package(
            c1 + UNKNOWN + UNKNOWN)),
        ("wrong-wire-type", _package(c1 + _tag(3, 2) + b"\x01A"), pkg(C1)),
        ("unknown-in-package", _package(c1, extra=UNKNOWN), pkg(C1)),
        ("unknown-in-config", _len(1, _len(1, c1) + UNKNOWN), pkg(C1)),
        ("unknown-in-policy", _package(c1_policy_unknown), pkg(C1)),
        ("unknown-in-policy-both", _package(c1_policy_unknown), _package(c1_policy_unknown)),
    ]


def test_collection_config_rules_same_strings():
    outcomes = {}
    for case, raw, committed in _cases():
        want = jleg.validate_collection_config_package(raw, committed)
        got = tleg.validate_collection_config_package(raw, committed)
        assert got == want, case
        outcomes[case] = got
    assert outcomes["valid"] is None and outcomes["grown"] is None
    assert "cannot be modified" in outcomes["modified"]
    assert "cannot be modified" in outcomes["unknown-in-new-only"]
    assert outcomes["unknown-in-both"] is None and outcomes["unknown-reordered"] is None
    assert outcomes["known-reordered"] is None
    assert "missing" in outcomes["dropped"]
    assert "cannot be modified" in outcomes["unknown-in-policy"]
    assert outcomes["unknown-in-policy-both"] is None


def _deploy_ws(rw, cc, coll_value=None, coll_key=None, ns="lscc", extra=()):
    writes = [rw.KVWrite(cc, False, b"ccdata")]
    if coll_value is not None:
        writes.append(rw.KVWrite(coll_key or cc + "~collection", False, coll_value))
    writes += [rw.KVWrite(k, False, b"v") for k in extra]
    return rw.TxRwSet((rw.NsRwSet(ns, (), tuple(writes)),))


def test_write_set_guards_same_strings():
    """check_v12_writeset and check_v13_writeset on deploys, upgrades and
    invokes: the same string (or None) in both packages."""
    good = both_packages([C1])[0]
    grown = both_packages([C1, C2])[0]
    modified = both_packages([{"name": "c1", "policy": "OR('Org2MSP.member')"}])[0]
    cases = [
        ("mycc", {"cc": "mycc", "ns": "mycc"}, None),
        ("mycc", {"cc": "mycc"}, None),
        ("lscc", {"cc": "mycc"}, None),
        ("lscc", {"cc": "mycc", "extra": ["other"]}, None),
        ("lscc", {"cc": "cscc"}, None),
        ("mycc", {"cc": "x", "ns": "cscc"}, None),
        ("mycc", {"cc": "x", "ns": "_lifecycle"}, None),
        ("lscc", {"cc": "mycc", "coll_value": good}, None),
        ("lscc", {"cc": "mycc", "coll_value": good, "coll_key": "othercc~collection"}, None),
        ("lscc", {"cc": "mycc", "coll_value": b"\xff\xfe\xfd"}, None),
        ("lscc", {"cc": "mycc", "coll_value": grown}, good),
        ("lscc", {"cc": "mycc", "coll_value": modified}, good),
        ("lscc", {"cc": "mycc", "coll_value": good, "extra": ["a~collection"]}, None),
    ]
    seen = set()
    for invoked, kw, committed in cases:
        get = (lambda cc, committed=committed: committed) if committed is not None else None
        for check in ("check_v12_writeset", "check_v13_writeset"):
            args = (get,) if check == "check_v13_writeset" else ()
            want = getattr(jleg, check)(_deploy_ws(jrw, **kw), invoked, *args)
            got = getattr(tleg, check)(_deploy_ws(trw, **kw), invoked, *args)
            assert got == want, (invoked, kw, check)
            seen.add(got)
    assert None in seen and len(seen) > 6
    assert tleg.check_v12_writeset(None, "mycc") is None
    assert tleg.collection_key("mycc") == jleg.collection_key("mycc") == "mycc~collection"
