"""The port's multi-channel validator (`parallel/multichannel.py`, BASELINE
config #5's path) against per-channel validation.

Three channels, each a 12-tx block built with the JAX package (its
cryptogen, txbuilder and protobuf) that mixes valid txs with invalid kinds
(a bad creator signature, a missing endorsement, a bad txid, a nil
envelope, an unknown chaincode, a foreign channel, a tampered endorsement,
an in-block duplicate), through one `MultiChannelValidator.validate` on the
CPU, where K1 (`p256_kernel.verify_batch`, counted here) runs its plain
version over the three channels' lanes laid end to end. Each channel's
flags and written-back block must equal the port's own `BlockValidator` on
that block alone and the JAX package's `BlockValidator` over its
`SoftwareProvider`; K1 is called once per `validate`; an unknown channel
raises; and the epilogue hands each channel exactly its own lanes of the
one mask (with fakes, as `tests/test_parallel.py` does for the JAX module).

The JAX package's `MultiChannelValidator` is not run here: it needs a
device mesh and compiles the vmapped K1 program, about 14 GB and minutes on
XLA:CPU for one shape (ROADMAP: one JAX verify program costs about 85 s
and 14 GB on this CPU). Its per-channel semantics are the single-channel
validator's, which is what each channel is held to.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch.common.limbparams import NLIMBS
from fabric_tpu_torch.common.txflags import TxValidationCode as V
from fabric_tpu_torch.ops import p256_kernel as pk
from fabric_tpu_torch.parallel import multichannel as mc
from fabric_tpu_torch.parallel.sharded import channel_stack, pad_lanes
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.validation import validator as tval
from test_torch_validator import (SW, OracleProvider, bad_creator_sig, bad_txid, make_block,
                                  make_tx, net, registries, tampered_endorsement)
from torch_untraced import untraced  # noqa: F401

CHANNELS = ("chA", "chB", "chC")
TXS = 12

__all__ = ["net"]  # the module fixture, shared with test_torch_validator


def _channel_block(net, channel, number):
    """12 txs: valid ones among eight invalid kinds, in an order that
    differs per channel."""
    dup = make_tx(net, channel=channel)
    kinds = [
        make_tx(net, channel=channel),
        bad_creator_sig(net, make_tx(net, channel=channel)),
        make_tx(net, channel=channel, endorsers=("p1",)),
        bad_txid(net, make_tx(net, channel=channel)),
        b"",
        make_tx(net, channel=channel, cc="nosuchcc"),
        make_tx(net, channel="otherchannel"),
        tampered_endorsement(net, make_tx(net, channel=channel)),
        dup,
        dup,
        make_tx(net, channel=channel, cc="anycc", endorsers=("p2",)),
        make_tx(net, channel=channel, endorsers=("p2", "p1")),
    ]
    shift = CHANNELS.index(channel) * 5
    return make_block(kinds[shift:] + kinds[:shift], number)


def _port_validator(net, channel):
    jmgr, tmgr = net["mgrs"]
    return tval.BlockValidator(channel, tmgr, OracleProvider(), registries()[1])


@pytest.fixture(scope="module")
def run(net):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        blocks = {ch: _channel_block(net, ch, 3 + k) for k, ch in enumerate(CHANNELS)}
        raw = {ch: b.SerializeToString() for ch, b in blocks.items()}
        jmgr, _ = net["mgrs"]
        jax_flags, jax_blocks, alone = {}, {}, {}
        for ch in CHANNELS:
            jb = common_pb2.Block()
            jb.CopyFrom(blocks[ch])
            jax_flags[ch] = jval.BlockValidator(ch, jmgr, SW, registries()[0]).validate(jb).tobytes()
            jax_blocks[ch] = jb.SerializeToString()
            alone[ch] = _port_validator(net, ch).validate(
                wire.decode(fabric.BLOCK, raw[ch])).tobytes()
        calls = []
        real = pk.verify_batch

        def counted(*args):
            calls.append(args[0].shape[1])
            return real(*args)

        validators = {ch: _port_validator(net, ch) for ch in CHANNELS}
        multi = mc.MultiChannelValidator(validators, device="cpu")
        tblocks = {ch: wire.decode(fabric.BLOCK, raw[ch]) for ch in CHANNELS}
        mp = pytest.MonkeyPatch()
        mp.setattr(pk, "verify_batch", counted)
        try:
            flags = multi.validate(tblocks)
        finally:
            mp.undo()
        return {"jax": jax_flags, "jax_blocks": jax_blocks, "alone": alone, "calls": calls,
                "flags": {ch: f.tobytes() for ch, f in flags.items()}, "blocks": tblocks,
                "multi": multi, "validators": validators}
    finally:
        torch.set_num_threads(before)


def test_flags_equal_per_channel_port_and_jax_validation(run):
    for ch in CHANNELS:
        assert run["flags"][ch] == run["alone"][ch] == run["jax"][ch], ch
        assert wire.encode(fabric.BLOCK, run["blocks"][ch]) == run["jax_blocks"][ch], ch
    codes = {V(c) for ch in CHANNELS for c in run["flags"][ch]}
    assert {V.VALID, V.BAD_CREATOR_SIGNATURE, V.ENDORSEMENT_POLICY_FAILURE, V.BAD_PROPOSAL_TXID,
            V.NIL_ENVELOPE, V.INVALID_CHAINCODE, V.TARGET_CHAIN_NOT_FOUND,
            V.DUPLICATE_TXID} <= codes


def test_k1_once_per_validate_over_every_channel(run):
    # 12 txs: 11 envelopes with jobs, 1 to 2 endorsements each; each
    # channel's lanes padded to one bucket of 128
    assert run["calls"] == [len(CHANNELS) * 128]
    for ch, v in run["validators"].items():
        assert v.last_parser == "native" and v.last_sig_backend == "cpu-reference", ch
    multi = run["multi"]
    assert multi.last_device_ms > 0
    assert set(multi.last_split_ms) == set(CHANNELS)
    for split in multi.last_split_ms.values():
        assert set(split) == {"parse", "collect", "prep_limbs", "epilogue"}


def test_unknown_channel_raises(net):
    multi = mc.MultiChannelValidator({"chA": _port_validator(net, "chA")}, device="cpu")
    with pytest.raises(KeyError):
        multi.validate({"nope": wire.decode(fabric.BLOCK, make_block([]).SerializeToString())})


def test_epilogue_slices_the_mask_per_channel(monkeypatch):
    """Each channel's verdicts are exactly its own stretch of the one mask,
    its first n lanes, the padding dropped (fakes: K1 returns its valid_in
    mask, the prep marks every other lane live)."""

    class FakePrep:
        device = torch.device("cpu")

        def prep_limbs(self, keys, sigs, digests):
            n = len(keys)
            limbs = tuple(np.zeros((NLIMBS, n), dtype=np.int64) for _ in range(5))
            return (*limbs, np.array([i % 2 == 0 for i in range(n)]))

        def describe_backend(self):
            return "fake"

    class FakeValidator:
        def __init__(self, n):
            self.n = n

        def collect_sig_jobs(self, parsed):
            jobs = list(range(self.n))
            return jobs, jobs, jobs, jobs, jobs

        def finish_sig_results(self, jobs, job_identity, ok_list):
            return ok_list

        def validate(self, block, parsed, sig_results=None):
            return sig_results

    calls = []
    monkeypatch.setattr(mc, "parse_block", lambda data: data)
    monkeypatch.setattr(pk, "verify_batch", lambda *args: calls.append(args) or args[-1])
    v = mc.MultiChannelValidator.__new__(mc.MultiChannelValidator)
    v.validators = {"a": FakeValidator(3), "b": FakeValidator(5), "c": FakeValidator(0)}
    v._prep = FakePrep()
    out = v.validate({"a": {}, "b": {}, "c": {}})
    assert out == {"a": [True, False, True], "b": [True, False, True, False, True], "c": []}
    assert len(calls) == 1 and calls[0][0].shape == (NLIMBS, 3 * 128)


def test_channel_stack_pads_and_refuses_overflow():
    limbs = tuple(np.full((NLIMBS, 2), k, dtype=np.int64) for k in range(1, 6))
    stacked = channel_stack([(*limbs, np.array([True, False]))], 4, 2)
    assert [a.shape for a in stacked] == [(2, NLIMBS, 4)] * 5 + [(2, 4)]
    assert stacked[5].tolist() == [[True, False, False, False], [False] * 4]
    assert (stacked[2][0, :, :2] == 3).all() and not stacked[2][0, :, 2:].any()
    assert pad_lanes(300, 128) == 384 and pad_lanes(256, 128) == 256
    with pytest.raises(ValueError):
        channel_stack([(*limbs, np.ones(2, bool))], 1, 1)
    with pytest.raises(ValueError):
        channel_stack([(*limbs, np.ones(2, bool))] * 2, 4, 1)
