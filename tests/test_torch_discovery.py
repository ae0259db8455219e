"""The port's service discovery (fabric_tpu_torch.discovery) against the
JAX package's, with no tolerance: tests/test_discovery.py's principal-set
cases, 200 seeded random policies (nested AND / OR / OutOf over five orgs
and four roles) whose `satisfied_by` sets are equal in order and content,
the combination cap raising in both; and the service's peers / config /
endorsers answers over bundles of one genesis (the port's encoder), each
client authorized by the channel's Readers policy, a stranger refused (and
the refusal cached) in both, unknown channels and chaincodes refused
alike, and a layout no online peer can fill refused alike. The port's
departure: a provider that fails raises out of the query and leaves no
cached verdict."""

import random

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import torch_orderer_world as W  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.discovery import DiscoveryService as JService  # noqa: E402
from fabric_tpu.discovery import PeerInfo as JPeer  # noqa: E402
from fabric_tpu.discovery import satisfied_by as jsat  # noqa: E402
from fabric_tpu.discovery.inquire import TooManyCombinationsError as JTooMany  # noqa: E402
from fabric_tpu.discovery.service import DiscoveryError as JDiscoveryError  # noqa: E402
from fabric_tpu.policy import from_dsl as jdsl  # noqa: E402
from fabric_tpu.policy.manager import SignedData as JSignedData  # noqa: E402
from fabric_tpu_torch.channelconfig import bundle as tbundle  # noqa: E402
from fabric_tpu_torch.discovery import DiscoveryService, PeerInfo, satisfied_by  # noqa: E402
from fabric_tpu_torch.discovery.inquire import TooManyCombinationsError  # noqa: E402
from fabric_tpu_torch.discovery.service import DiscoveryError  # noqa: E402
from fabric_tpu_torch.policy.ast import from_dsl  # noqa: E402
from fabric_tpu_torch.policy.manager import SignedData  # noqa: E402

CHANNEL = "dchannel"


def sets(result):
    return [tuple((p.msp_id, p.role.value) for p in s) for s in result]


DSLS = [
    "AND('A.member','B.member')",
    "OR('A.member','B.member')",
    "OutOf(2,'A.member','B.member','C.member')",
    "AND('A.member', OR('B.member','C.member'))",
    "OutOf(2,'A.member','A.member','B.admin')",
    "OR(AND('A.peer','B.peer'), AND('A.peer','C.client'))",
    "OutOf(0,'A.member')",
]


@pytest.mark.parametrize("dsl", DSLS)
def test_satisfied_by_cases_equal_jax(dsl):
    assert sets(satisfied_by(from_dsl(dsl))) == sets(jsat(jdsl(dsl)))


def test_satisfied_by_expectations():
    """tests/test_discovery.py's expectations, on the port."""
    assert sets(satisfied_by(from_dsl("AND('A.member','B.member')"))) == [
        (("A", "member"), ("B", "member"))]
    assert sets(satisfied_by(from_dsl("OR('A.member','B.member')"))) == [
        (("A", "member"),), (("B", "member"),)]
    got = sets(satisfied_by(from_dsl("OutOf(2,'A.member','B.member','C.member')")))
    assert sorted(got) == [(("A", "member"), ("B", "member")), (("A", "member"), ("C", "member")),
                           (("B", "member"), ("C", "member"))]


def random_dsl(rng, depth=0):
    if depth >= 3 or rng.random() < 0.35:
        return f"'Org{rng.randrange(5)}.{rng.choice(['member', 'admin', 'peer', 'client'])}'"
    n = rng.randrange(1, 5)
    children = ",".join(random_dsl(rng, depth + 1) for _ in range(n))
    kind = rng.randrange(3)
    if kind == 0:
        return f"AND({children})"
    if kind == 1:
        return f"OR({children})"
    return f"OutOf({rng.randrange(0, n + 1)},{children})"


@pytest.mark.parametrize("seed", range(4))
def test_satisfied_by_random_policies_equal_jax(seed):
    rng = random.Random(seed)
    for _ in range(50):
        dsl = random_dsl(rng)
        if not dsl.startswith(("AND", "OR", "OutOf")):
            dsl = f"OR({dsl})"
        try:
            want = sets(jsat(jdsl(dsl)))
        except JTooMany:
            with pytest.raises(TooManyCombinationsError):
                satisfied_by(from_dsl(dsl))
            continue
        assert sets(satisfied_by(from_dsl(dsl))) == want, dsl


def test_combination_cap():
    terms = ",".join(f"'O{i}.member'" for i in range(30))
    with pytest.raises(TooManyCombinationsError):
        satisfied_by(from_dsl(f"OutOf(15,{terms})"))
    with pytest.raises(JTooMany):
        jsat(jdsl(f"OutOf(15,{terms})"))


PEERS = [("Org1MSP", "peer0.org1:7051", 10, ("mycc",)),
         ("Org1MSP", "peer1.org1:7051", 12, ("mycc", "other")),
         ("Org2MSP", "peer0.org2:7051", 11, ("mycc",)),
         ("Org2MSP", "peer1.org2:7051", 9, ("other",))]
POLICIES = {"mycc": "AND('Org1MSP.member','Org2MSP.member')",
            "other": "OutOf(2,'Org1MSP.peer','Org2MSP.member','OrgXMSP.member')",
            "lonely": "AND('Org2MSP.member','Org2MSP.member')"}


@pytest.fixture(scope="module")
def world():
    w = W.World(1705)
    raw = w.genesis(CHANNEL)
    tb = tbundle.bundle_from_genesis_block(W.port_block(raw), w.provider)
    jb = jbundle.bundle_from_genesis_block(W.jax_block(raw), W.SW)
    tpeers = [PeerInfo(*p) for p in PEERS]
    jpeers = [JPeer(*p) for p in PEERS]
    w.svc = DiscoveryService(
        peers_provider=lambda ch: tpeers if ch == CHANNEL else [],
        bundle_provider=lambda ch: tb if ch == CHANNEL else None,
        policy_provider=lambda cc, ch: from_dsl(POLICIES[cc]) if cc in POLICIES else None)
    w.jsvc = JService(
        peers_provider=lambda ch: jpeers if ch == CHANNEL else [],
        bundle_provider=lambda ch: jb if ch == CHANNEL else None,
        policy_provider=lambda cc, ch: jdsl(POLICIES[cc]) if cc in POLICIES else None)
    w.tb = tb
    return w


def clients(world, node):
    s = world.signer(node)
    sig = s.sign(b"req")
    return SignedData(b"req", s.serialize(), sig), JSignedData(b"req", s.serialize(), sig)


def peer_view(peers):
    return [(p.msp_id, p.endpoint, p.ledger_height, tuple(p.chaincodes), p.is_peer_role)
            for p in peers]


def ask(world, query, *args, node=None):
    """The same query of both services: ("ok", answer) or ("error", text)."""
    t, j = clients(world, node or world.org1.users[0])
    out = []
    for svc, client, error in ((world.svc, t, DiscoveryError), (world.jsvc, j, JDiscoveryError)):
        try:
            got = getattr(svc, query)(*args, client)
        except error as e:
            out.append(("error", str(e)))
            continue
        if query == "peers":
            got = peer_view(got)
        elif query == "endorsers":
            got = (got.chaincode, {g: peer_view(m) for g, m in got.endorsers_by_groups.items()},
                   got.layouts)
        out.append(("ok", got))
    assert out[0] == out[1]
    return out[0]


def test_peers_query(world):
    status, got = ask(world, "peers", CHANNEL)
    assert status == "ok" and [p[1] for p in got] == [
        "peer0.org1:7051", "peer1.org1:7051", "peer0.org2:7051", "peer1.org2:7051"]


def test_config_query(world):
    status, cfg = ask(world, "config", CHANNEL, node=world.org2.users[0])
    assert status == "ok" and cfg["msps"] == ["OrdererMSP", "Org1MSP", "Org2MSP"]
    assert cfg["orderers"] == {"OrdererMSP": ["orderer0.world:7050"]}


@pytest.mark.parametrize("chaincode", ["mycc", "other", "lonely", "nope"])
def test_endorsers_query(world, chaincode):
    status, got = ask(world, "endorsers", CHANNEL, chaincode)
    if chaincode == "mycc":
        _, groups, layouts = got
        assert len(layouts) == 1 and sorted(layouts[0].values()) == [1, 1]
        assert sorted(len(m) for m in groups.values()) == [1, 2]
        for members in groups.values():  # by ledger height, highest first
            assert [m[2] for m in members] == sorted((m[2] for m in members), reverse=True)
    elif chaincode == "other":
        assert status == "ok" and len(got[2]) == 1
    else:
        assert status == "error"


def test_auth_refuses_stranger_and_caches(world):
    for _ in range(2):  # the second answer comes from the cache, alike
        status, text = ask(world, "peers", CHANNEL, node=world.stranger_org.users[0])
        assert status == "error" and text.startswith("access denied")
    assert ask(world, "peers", "nochannel") == ("error", "channel nochannel not found")


@pytest.mark.parametrize("error", [RuntimeError, ValueError])
def test_failing_provider_raises_and_caches_nothing(error, world):
    """Departure: the Readers check over a provider that fails raises out of
    the query, and the next query over a healthy provider is answered."""
    class Broken(type(world.provider)):
        def verify(self, key, signature, digest):
            raise error("device lost")

        def batch_verify(self, keys, signatures, digests):
            raise error("device lost")

    raw = world.genesis(CHANNEL)
    bundles = {"b": tbundle.bundle_from_genesis_block(W.port_block(raw), Broken())}
    svc = DiscoveryService(lambda ch: [PeerInfo(*PEERS[0])], lambda ch: bundles["b"],
                           lambda cc, ch: None)
    client, _ = clients(world, world.org1.users[0])
    with pytest.raises(error, match="device lost"):
        svc.peers(CHANNEL, client)
    assert svc._auth_cache == {}
    bundles["b"] = world.tb
    assert [p.endpoint for p in svc.peers(CHANNEL, client)] == ["peer0.org1:7051"]
