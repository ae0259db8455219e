"""Block creation + signing shared by all consenters (reference
orderer/common/multichannel/blockwriter.go).

The writer chains blocks by previous_hash, tracks the latest config block
index, signs the SIGNATURES metadata (value = OrdererBlockMetadata-style
LastConfig, signed bytes = value || signature_header || block_header DER),
and hands finished blocks to a sink (the channel's block store and any
deliver subscribers).

The port's counterpart of the JAX package's `orderer/blockwriter.py`: blocks
and envelopes are message dicts, and a block's header, data and metadata
bytes are the JAX writer's for the same envelopes, signer and nonces.
`block_signature_verifier` reads a failed policy (`PolicyError`) as False
and lets any other error through, as the port's policy manager does (a
failing device never reads as a denial); the JAX verifier reads every
exception as False.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from fabric_tpu_torch.protos import fabric, protoutil, wire


class BlockWriter:
    def __init__(
        self,
        signer=None,
        sink: Optional[Callable[[dict], None]] = None,
        last_block: Optional[dict] = None,
        last_config_index: int = 0,
    ):
        self.signer = signer
        self.sink = sink
        self._last_config_index = last_config_index
        if last_block is not None:
            self.height = last_block["header"].get("number", 0) + 1
            self._last_hash = protoutil.block_header_hash(last_block["header"])
        else:
            self.height = 0
            self._last_hash = b""

    def create_next_block(self, envelopes: Sequence[dict]) -> dict:
        block = protoutil.new_block(self.height, self._last_hash)
        block["data"]["data"] = [wire.encode(fabric.ENVELOPE, env) for env in envelopes]
        return protoutil.seal_block(block)

    def append_bootstrap(self, block: dict) -> None:
        """Adopt an externally-created block (genesis or latest config
        block on join) AS-IS: no re-signing, no mutation — the stored
        bytes must stay identical to the configtx artifact. Initializes
        the chain position from the block's own number."""
        number = block["header"].get("number", 0)
        self.height = number + 1
        self._last_hash = protoutil.block_header_hash(block["header"])
        self._last_config_index = number
        if self.sink is not None:
            self.sink(block)

    def write_block(self, block: dict, is_config: bool = False) -> None:
        """Sign + advance the chain. Blocks must arrive in order."""
        number = block["header"].get("number", 0)
        if number != self.height:
            raise ValueError(f"wrote block {number}, expected {self.height}")
        if is_config:
            self._last_config_index = number
        self._add_signature_metadata(block)
        self.height += 1
        self._last_hash = protoutil.block_header_hash(block["header"])
        if self.sink is not None:
            self.sink(block)

    def _add_signature_metadata(self, block: dict) -> None:
        protoutil.init_block_metadata(block)
        meta = {"value": wire.encode(fabric.LAST_CONFIG, {"index": self._last_config_index})}
        if self.signer is not None:
            shdr = wire.encode(fabric.SIGNATURE_HEADER, protoutil.make_signature_header(
                self.signer.serialize(), self.signer.new_nonce()))
            signed = meta["value"] + shdr + protoutil.block_header_bytes(block["header"])
            meta["signatures"] = [{"signature_header": shdr,
                                   "signature": self.signer.sign(signed)}]
        block["metadata"]["metadata"][fabric.SIGNATURES] = wire.encode(fabric.METADATA, meta)

    @property
    def last_config_index(self) -> int:
        return self._last_config_index


def block_signature_verifier(bundle_getter, policy_name: str = "/Channel/Orderer/BlockValidation"):
    """Returns verify(block) -> bool for the peer's MCS.VerifyBlock
    (reference internal/peer/gossip/mcs.go:124): evaluate the
    BlockValidation policy over the SIGNATURES metadata signatures (through
    the bundle's provider: K2 on `CUDAProvider`)."""
    from fabric_tpu_torch.policy.manager import PolicyError, SignedData

    def verify(block: dict) -> bool:
        bundle = bundle_getter()
        if bundle is None:
            return True
        slots = block.get("metadata", {}).get("metadata", [])
        if len(slots) <= fabric.SIGNATURES:
            return False
        meta = protoutil.unmarshal(fabric.METADATA, slots[fabric.SIGNATURES])
        header = protoutil.block_header_bytes(block["header"])
        signed_data = []
        for sig in meta.get("signatures", ()):
            shdr = protoutil.unmarshal(fabric.SIGNATURE_HEADER, sig.get("signature_header", b""))
            signed_data.append(SignedData(
                meta.get("value", b"") + sig.get("signature_header", b"") + header,
                shdr.get("creator", b""),
                sig.get("signature", b""),
            ))
        policy, ok = bundle.policy_manager.get_policy(policy_name)
        if not ok:
            return False
        try:
            policy.evaluate_signed_data(signed_data)
            return True
        except PolicyError:
            return False

    return verify
