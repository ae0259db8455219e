"""Shared material of the orderer and delivery differential tests
(tests/test_torch_{consenter_ids,broadcast,deliver,follower,discovery}.py):
orgs minted by the port's cryptogen from a seed, genesis blocks encoded by
the port's encoder and handed to both packages as the same bytes,
envelopes signed once by a port signer and read by both packages, and a
deterministic stand-in signer for the orderers' blocks so whole blocks
compare byte for byte.

The JAX package writes the ConfigEnvelopes it builds (a CONFIG envelope's
data, a new channel's genesis) with protobuf's default `SerializeToString()`,
whose map entries come in hash-table order: not even a parse and
re-serialize in the JAX package gives those bytes back. The port writes
upb's deterministic order. `deterministic_jax_maps` pins the JAX writer to
the deterministic order for a test, so the two packages' config blocks can
be held byte for byte."""

import datetime
import hashlib
import random

import chip_smoke
from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.protos import common_pb2, configtx_pb2
from fabric_tpu_torch.channelconfig import encoder as tenc
from fabric_tpu_torch.msp.cryptogen import generate_org
from fabric_tpu_torch.msp.signer import SigningIdentity
from fabric_tpu_torch.protos import ab, fabric, protoutil, wire

SW = SoftwareProvider()


def deterministic_jax_maps(monkeypatch) -> None:
    """Make the JAX package serialize the ConfigEnvelopes it builds (a
    CONFIG envelope's data, a new channel's genesis) in upb's
    deterministic order for the rest of the test."""
    base = configtx_pb2.ConfigEnvelope.SerializeToString
    monkeypatch.setattr(configtx_pb2.ConfigEnvelope, "SerializeToString",
                        lambda self, **kw: base(self, deterministic=True))


class StandIn:
    """A deterministic signer with the SigningIdentity surface, the same
    for both packages' orderers."""

    def __init__(self, name=b"orderer-identity"):
        self.name = name
        self.n = 0

    def serialize(self):
        return self.name

    def new_nonce(self):
        self.n += 1
        return b"nonce-%d" % self.n

    def sign(self, msg):
        return hashlib.sha256(msg).digest()


class World:
    """Org1 and Org2 (application), an orderer org, and a stranger org
    named Org1MSP under another CA."""

    def __init__(self, seed):
        rng = random.Random(seed)
        self.rng = rng
        self.org1 = generate_org("org1.world", "Org1MSP", rng=rng)
        self.org2 = generate_org("org2.world", "Org2MSP", rng=rng)
        self.oorg = generate_org("orderer.world", "OrdererMSP", rng=rng)
        self.stranger_org = generate_org("rogue.world", "Org1MSP", rng=rng)
        past = datetime.datetime.now(datetime.timezone.utc) - datetime.timedelta(days=400)
        self.expired_node = self.org1.ca.enroll("expired.org1.world", ou="client", now=past)
        self.provider = chip_smoke.oracle_provider({})

    def signer(self, node):
        return SigningIdentity(node, self.rng)

    def profile(self, orderer_type="solo", consenters=(), max_message_count=2,
                consortium="", addresses=("orderer0:7050",), app=True, consortiums=None):
        orgs = [tenc.OrganizationProfile("Org1MSP", self.org1.msp_config()),
                tenc.OrganizationProfile("Org2MSP", self.org2.msp_config())]
        return tenc.Profile(
            consortium=consortium,
            application=tenc.ApplicationProfile(organizations=orgs) if app else None,
            orderer=tenc.OrdererProfile(
                orderer_type=orderer_type, max_message_count=max_message_count,
                addresses=list(addresses), batch_timeout="100ms",
                organizations=[tenc.OrganizationProfile(
                    "OrdererMSP", self.oorg.msp_config(),
                    orderer_endpoints=["orderer0.world:7050"])],
                raft_consenters=[("127.0.0.1", p, b"", b"") for p in consenters]),
            consortiums=consortiums or {})

    def genesis(self, channel, **kw) -> bytes:
        return wire.encode(fabric.BLOCK, tenc.genesis_block(self.profile(**kw), channel))

    def system_genesis(self, channel) -> bytes:
        orgs = [tenc.OrganizationProfile("Org1MSP", self.org1.msp_config()),
                tenc.OrganizationProfile("Org2MSP", self.org2.msp_config())]
        profile = tenc.Profile(
            orderer=tenc.OrdererProfile(orderer_type="solo", organizations=[
                tenc.OrganizationProfile("OrdererMSP", self.oorg.msp_config())]),
            consortiums={"SampleConsortium": orgs})
        return wire.encode(fabric.BLOCK, tenc.genesis_block(profile, channel))


def envelope(signer, channel, body: bytes, header_type=fabric.ENDORSER_TRANSACTION) -> bytes:
    """A signed envelope's bytes (`signer` None: no signature header)."""
    chdr = wire.encode(fabric.CHANNEL_HEADER, protoutil.make_channel_header(header_type, channel))
    shdr = (wire.encode(fabric.SIGNATURE_HEADER, protoutil.make_signature_header(
        signer.serialize(), signer.new_nonce())) if signer is not None else b"")
    payload = wire.encode(fabric.PAYLOAD, {"header": {"channel_header": chdr,
                                                       "signature_header": shdr},
                                            "data": body})
    env = {"payload": payload}
    if signer is not None:
        env["signature"] = signer.sign(payload)
    return wire.encode(fabric.ENVELOPE, env)


def flip_signature(raw: bytes) -> bytes:
    env = wire.decode(fabric.ENVELOPE, raw)
    sig = env["signature"]
    env["signature"] = sig[:-1] + bytes([sig[-1] ^ 1])
    return wire.encode(fabric.ENVELOPE, env)


def port_env(raw: bytes) -> dict:
    return wire.decode(fabric.ENVELOPE, raw)


def jax_env(raw: bytes):
    return common_pb2.Envelope.FromString(raw)


def port_block(raw: bytes) -> dict:
    return wire.decode(fabric.BLOCK, raw)


def jax_block(raw: bytes):
    return common_pb2.Block.FromString(raw)


def response_bytes(resp) -> bytes:
    """A DeliverResponse's bytes: a port dict or a protobuf message (its
    deterministic bytes, whose map order the port's writer keeps)."""
    if isinstance(resp, dict):
        return wire.encode(ab.DELIVER_RESPONSE, resp)
    return resp.SerializeToString(deterministic=True)




class RaftCluster:
    """Raft orderers of one package ("port" or "jax") behind in-process
    queues, driven from the caller's thread (`run`: a tick of every live
    node, then deliveries until the queues are empty). Each node has a
    Registrar, a BroadcastHandler whose cluster client forwards to the
    leader's handler with forwarded=True, and a DeliverHandler over its
    chains whose waits end when a block is written."""

    def __init__(self, pkg, world, genesis: bytes, path, ids=(1, 2, 3), checker=None):
        import threading

        from fabric_tpu.deliver import server as jsrv
        from fabric_tpu.orderer import broadcast as jbc
        from fabric_tpu.orderer import multichannel as jmc
        from fabric_tpu_torch.deliver import server as tsrv
        from fabric_tpu_torch.orderer import broadcast as tbc
        from fabric_tpu_torch.orderer import multichannel as tmc

        self.pkg = pkg
        self.world = world
        self.path = path
        self.genesis = genesis
        self.queues = {}
        self.regs, self.handlers, self.delivers = {}, {}, {}
        self.partitioned = set()
        self.forwards = []
        self.written = threading.Condition()
        self._mods = (tmc, tbc, tsrv) if pkg == "port" else (jmc, jbc, jsrv)
        self._checker = checker
        for i in ids:
            self.start(i)

    def registrar(self, i, **kw):
        mc = self._mods[0]
        provider = self.world.provider if self.pkg == "port" else SW
        reg = mc.Registrar(str(self.path / f"o{i}"), signer=StandIn(), raft_node_id=i,
                           provider=provider, raft_transport_factory=self._transport, **kw)
        reg.on_block(self._notify)
        return reg

    def start(self, i, join=True):
        """Node i's Registrar (anew: a restart reopens its ledger and WAL)."""
        mc, bc, srv = self._mods
        self.queues[i] = []
        reg = self.registrar(i)
        if join:
            reg.join_channel(port_block(self.genesis) if self.pkg == "port"
                             else jax_block(self.genesis))
        self.regs[i] = reg
        self.handlers[i] = bc.BroadcastHandler(reg, cluster_client=self)
        self.delivers[i] = srv.DeliverHandler(self.source_for(reg), policy_checker=self._checker,
                                              wait_timeout=0.2)

    def source_for(self, reg):
        srv = self._mods[2]

        def source(channel_id):
            support = reg.get_chain(channel_id) or reg.followers.get(channel_id)
            if support is None:
                return None
            return srv.BlockSource(support.get_block, lambda: support.height,
                                   lambda n, timeout: self._wait(support, n, timeout))

        return source

    def _wait(self, support, n, timeout):
        with self.written:
            return self.written.wait_for(lambda: support.height > n, timeout)

    def _notify(self, channel_id, block):
        with self.written:
            self.written.notify_all()

    def _transport(self, channel, frm):
        def send(to, msg):
            if frm in self.partitioned or to in self.partitioned or to not in self.queues:
                return
            self.queues[to].append(msg)

        return send

    def forward_submit(self, channel_id, env, leader_id):
        self.forwards.append(leader_id)
        return self.handlers[leader_id].process_message(env, forwarded=True)

    def chain(self, i, channel):
        support = self.regs[i].get_chain(channel)
        return support.chain if support is not None else None

    def run(self, ticks, channel):
        for _ in range(ticks):
            for i in sorted(self.regs):
                chain = self.chain(i, channel)
                if i not in self.partitioned and chain is not None:
                    chain.tick()
            moved = True
            while moved:
                moved = False
                for i in sorted(self.queues):
                    q, self.queues[i] = self.queues[i], []
                    chain = self.chain(i, channel)
                    for m in q:
                        if i not in self.partitioned and chain is not None:
                            chain.step(m)
                            moved = True

    def leader(self, channel):
        return next((i for i in sorted(self.regs) if i not in self.partitioned
                     and self.chain(i, channel) is not None
                     and self.chain(i, channel).node.role == "leader"), None)

    def ledger(self, i, channel) -> list:
        """Node i's stored blocks as bytes."""
        support = self.regs[i].get_chain(channel) or self.regs[i].followers.get(channel)
        enc = ((lambda b: wire.encode(fabric.BLOCK, b)) if self.pkg == "port"
               else (lambda b: b.SerializeToString()))
        return [enc(support.get_block(n)) for n in range(support.height)]
