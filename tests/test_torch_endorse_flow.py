"""The slice as a whole at a small size, the port against the JAX package:
chip_smoke.py's endorse_config2 flow (`EndorseNet`, `endorsing_peer`) at 12
transactions a block. The same client-signed proposals (three rounds:
`put`, config #4's read-write conflicts, and a round with 8 proposals whose
client signature is flipped and an ordered envelope whose endorsement is)
go to Org1's and Org2's endorsers in both packages; every response's
status, message, payload bytes and endorser identity are equal, and each
endorsement signature verifies under the other package. The port's
envelopes are ordered by both packages' SoloChain, each block's orderer
signature verifies in both peers' Channels, and both packages' Channels
commit them (the port's through CommitPipeline and K5's plain version, the
JAX package's serially): the filters (against EndorseNet.codes), the commit
hashes and the state and history rows are equal. The port's peers share one
BatchingProvider over the port's P-256 oracle: K2's plain version takes
about 5 s a call on the CPU whatever its lanes, and each creator check is a
call; `test_endorsers_over_cuda_provider` runs a valid and a refused
proposal through both port endorsers over CUDAProvider(device="cpu")."""

import sqlite3

import pytest
import torch
from torch_untraced import untraced  # noqa: F401

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import chip_smoke  # noqa: E402
from fabric_tpu.chaincode import shim as jshim  # noqa: E402
from fabric_tpu.chaincode import support as jsup  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.crypto.bccsp import SoftwareProvider  # noqa: E402
from fabric_tpu.endorser import endorser as jend  # noqa: E402
from fabric_tpu.msp.cryptogen import NodeIdentity as JNode  # noqa: E402
from fabric_tpu.msp.signer import SigningIdentity as JSigner  # noqa: E402
from fabric_tpu.orderer import blockcutter as jcut  # noqa: E402
from fabric_tpu.orderer import blockwriter as jbw  # noqa: E402
from fabric_tpu.orderer import solo as jsolo  # noqa: E402
from fabric_tpu.peer.channel import Channel as JChannel  # noqa: E402
from fabric_tpu.policy import from_dsl as jdsl  # noqa: E402
from fabric_tpu.protos import common_pb2, peer_pb2  # noqa: E402
from fabric_tpu.validation import validator as jval  # noqa: E402
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider  # noqa: E402
from fabric_tpu_torch.msp.identity import MSP, MSPManager  # noqa: E402
from fabric_tpu_torch.orderer.blockcutter import BatchConfig  # noqa: E402
from fabric_tpu_torch.orderer.solo import SoloChain  # noqa: E402
from fabric_tpu_torch.parallel.batcher import BatchingProvider  # noqa: E402
from fabric_tpu_torch.peer.pipeline import CommitPipeline  # noqa: E402
from fabric_tpu_torch.protos import fabric, wire  # noqa: E402

SW = SoftwareProvider()
TXS = 12


def jax_signer(node):
    from cryptography.hazmat.primitives.asymmetric import ec

    return JSigner(JNode(node.name, node.cert_pem, ec.derive_private_key(
        node.priv_scalar, ec.SECP256R1()), node.msp_id), SW)


def jax_peer(en, k, path):
    """The JAX package's peer k: a Channel over the genesis bundle (the
    orderer signature checked by its block_signature_verifier), the genesis
    committed, an Endorser with benchcc over SoftwareProvider."""
    genesis_raw = wire.encode(fabric.BLOCK, en.genesis)
    bundle = jbundle.bundle_from_genesis_block(common_pb2.Block.FromString(genesis_raw), SW)
    registry = jval.ChaincodeRegistry([jval.ChaincodeDefinition(
        "benchcc", jdsl(chip_smoke.CONFIG2_POLICY))])
    ch = JChannel(en.channel, path, bundle.msp_manager, registry, SW,
                  verify_orderer_sig=jbw.block_signature_verifier(lambda: bundle))
    ch.ledger.commit(common_pb2.Block.FromString(genesis_raw))
    support = jsup.ChaincodeSupport()
    support.register("benchcc", chip_smoke.BenchCC(jshim))
    endorser = jend.Endorser(jax_signer(en.net.endorsers[k].node), bundle.msp_manager, support,
                             get_ledger=lambda cid: ch.ledger if cid == en.channel else None)
    return ch, endorser


def responses_equal(tresps, jresps, tmgr, jmgr):
    """Statuses, messages, payloads and endorsers equal; each endorsement
    verifies under the other package's identity."""
    for t, j in zip(tresps, jresps):
        r = t["response"]
        assert (r.get("status", 0), r.get("message", ""), r.get("payload", b""),
                t.get("payload", b""), t.get("endorsement", {}).get("endorser", b"")) == (
            j.response.status, j.response.message, j.response.payload, j.payload,
            j.endorsement.endorser)
        if r.get("status") == 200:
            endorser = t["endorsement"]["endorser"]
            jmgr.deserialize_identity(endorser)[0].verify(t["payload"] + endorser,
                                                          t["endorsement"]["signature"])
            tmgr.deserialize_identity(endorser)[0].verify(j.payload + endorser,
                                                          j.endorsement.signature)


def rows(path, table):
    db = sqlite3.connect(str(path))
    try:
        return sorted(db.execute(f"SELECT * FROM {table}").fetchall())
    finally:
        db.close()


def test_flow_equals_jax(tmp_path):
    torch.set_num_threads(1)
    en = chip_smoke.EndorseNet(seed=3171)
    bp = BatchingProvider(chip_smoke.oracle_provider({}))
    tpeers = [chip_smoke.endorsing_peer(en, k, str(tmp_path / f"t{k}"), bp, "cpu")
              for k in range(2)]
    jpeers = [jax_peer(en, k, str(tmp_path / f"j{k}")) for k in range(2)]
    committed = [[], []]
    pipes = [CommitPipeline(ch, depth=chip_smoke.PIPELINE_DEPTH, on_commit=(
        lambda b, f, k=k: committed[k].append(
            (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH]))))
        for k, (ch, _) in enumerate(tpeers)]
    delivered, jdelivered = [], []
    solo = SoloChain(en.channel, signer=en.cn.orderer,
                     batch_config=BatchConfig(max_message_count=TXS),
                     deliver=lambda b: delivered.append(wire.encode(fabric.BLOCK, b)),
                     genesis_block=en.genesis)
    jsolo_chain = jsolo.SoloChain(
        en.channel, signer=jax_signer(en.cn.orderer.node),
        batch_config=jcut.BatchConfig(max_message_count=TXS),
        deliver=lambda b: jdelivered.append(b.SerializeToString()),
        genesis_block=common_pb2.Block.FromString(delivered[0]))
    jflags = [[], []]
    try:
        for rnd, (_, _, refused, _) in enumerate(chip_smoke.ENDORSE_ROUNDS):
            endorsed = []
            for bundle, signed, is_refused in en.proposals(rnd, TXS):
                raw = wire.encode(fabric.SIGNED_PROPOSAL, signed)
                tresps = [e.process_proposal(wire.decode(fabric.SIGNED_PROPOSAL, raw))
                          for _, e in tpeers]
                jresps = [e.process_proposal(peer_pb2.SignedProposal.FromString(raw))
                          for _, e in jpeers]
                responses_equal(tresps, jresps, tpeers[0][1].msp_manager,
                                jpeers[0][1].msp_manager)
                want = (500, "access denied: The signature is invalid") if is_refused else (
                    200, "")
                assert [(r["response"]["status"], r["response"].get("message", ""))
                        for r in tresps] == [want] * 2
                if not is_refused:
                    endorsed.append((bundle, tresps))
            assert len(endorsed) == TXS
            envs = en.envelopes(rnd, endorsed, TXS)
            for env in envs:
                solo.order(env)
                jsolo_chain.order(common_pb2.Envelope.FromString(wire.encode(fabric.ENVELOPE,
                                                                             env)))
            assert len(delivered) == len(jdelivered) == rnd + 2
            tblock = wire.decode(fabric.BLOCK, delivered[-1])
            jblock = wire.decode(fabric.BLOCK, jdelivered[-1])
            assert (tblock["header"], tblock["data"]) == (jblock["header"], jblock["data"])
            # each package's orderer signature verifies in the other's peers
            for pipe in pipes:
                pipe.submit(wire.decode(fabric.BLOCK, jdelivered[-1]))
            assert all(pipe.drain(timeout=120) for pipe in pipes)
            for k, (ch, _) in enumerate(jpeers):
                b = common_pb2.Block.FromString(delivered[-1])
                jflags[k].append((ch.store_block(b).tobytes(),
                                  b.metadata.metadata[fabric.COMMIT_HASH]))
        want_codes = [en.codes(rnd, TXS) for rnd in range(len(chip_smoke.ENDORSE_ROUNDS))]
        assert [f for f, _ in committed[0]] == want_codes
        assert committed[0] == committed[1] == jflags[0] == jflags[1]
        assert want_codes[1].count(11) == 1 and want_codes[2].count(10) == 1
        for table in ("state", "history"):
            want_rows = rows(tmp_path / "j0" / f"{en.channel}.state.db", table)
            assert want_rows
            for path in ("t0", "t1", "j1"):
                assert rows(tmp_path / path / f"{en.channel}.state.db", table) == want_rows
    finally:
        for pipe in pipes:
            pipe.stop()
        bp.stop()
        for ch, _ in tpeers + jpeers:
            ch.ledger.close()


def test_endorsers_over_cuda_provider(tmp_path):
    """Round 0's first proposal and a refused one through both port
    endorsers whose MSPs verify on CUDAProvider(device="cpu") (K2's plain
    version, one call a creator check), against the JAX endorsers."""
    torch.set_num_threads(1)
    en = chip_smoke.EndorseNet(seed=3172)
    provider = CUDAProvider(device="cpu")
    calls = []
    real = provider.verify

    def verify(key, sig, digest):
        calls.append(sig)
        return real(key, sig, digest)

    provider.verify = verify
    tpeers = [chip_smoke.endorsing_peer(en, k, str(tmp_path / f"t{k}"), provider, "cpu",
                                        device_mvcc=False) for k in range(2)]
    jpeers = [jax_peer(en, k, str(tmp_path / f"j{k}")) for k in range(2)]
    # the JAX endorsements are verified over the oracle, not K2's plain version
    oracle_mgr = MSPManager([MSP(c, provider=chip_smoke.oracle_provider())
                             for c in en.net.msp_configs()])
    try:
        props = en.proposals(2, TXS)
        picked = [props[0]] + [p for p in props if p[2]][:1]
        assert [p[2] for p in picked] == [False, True]
        for _, signed, is_refused in picked:
            raw = wire.encode(fabric.SIGNED_PROPOSAL, signed)
            tresps = [e.process_proposal(wire.decode(fabric.SIGNED_PROPOSAL, raw))
                      for _, e in tpeers]
            jresps = [e.process_proposal(peer_pb2.SignedProposal.FromString(raw))
                      for _, e in jpeers]
            responses_equal(tresps, jresps, oracle_mgr, jpeers[0][1].msp_manager)
            assert [r["response"]["status"] for r in tresps] == [500 if is_refused else 200] * 2
        assert calls == [picked[0][1]["signature"]] * 2 + [picked[1][1]["signature"]] * 2
    finally:
        for ch, _ in tpeers + jpeers:
            ch.ledger.close()
