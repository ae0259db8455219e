"""qscc — ledger query system chaincode (reference core/scc/qscc/query.go).

Functions (args[0]=fn, args[1]=channelID, args[2]=param):
GetChainInfo, GetBlockByNumber, GetBlockByHash, GetTransactionByID,
GetBlockByTxID. Results are serialized protos, matching the reference's
payloads (BlockchainInfo / Block / ProcessedTransaction).

ACL checks run in the endorser via aclmgmt before dispatch; qscc itself
re-checks nothing (the reference checks ACLs inside Invoke — here the
shared aclmgmt hook covers both entry points).

The port's counterpart of the JAX package's `scc/qscc.py`, over the port's
`KVLedger` and block store: the same payload bytes for the same chain.
"""

from __future__ import annotations

from typing import Callable, Optional

from fabric_tpu_torch.chaincode.shim import ChaincodeStub, Response, error_response, success
from fabric_tpu_torch.protos import fabric, protoutil, wire

GET_CHAIN_INFO = "GetChainInfo"
GET_BLOCK_BY_NUMBER = "GetBlockByNumber"
GET_BLOCK_BY_HASH = "GetBlockByHash"
GET_TRANSACTION_BY_ID = "GetTransactionByID"
GET_BLOCK_BY_TX_ID = "GetBlockByTxID"


class QSCC:
    def __init__(self, get_ledger: Callable[[str], Optional[object]]):
        self._get_ledger = get_ledger

    def init(self, stub: ChaincodeStub) -> Response:
        return success()

    def invoke(self, stub: ChaincodeStub) -> Response:
        args = stub.get_args()
        if len(args) < 2:
            return error_response(f"Incorrect number of arguments, {len(args)}")
        fname = args[0].decode()
        cid = args[1].decode()
        ledger = self._get_ledger(cid)
        if ledger is None:
            return error_response(f"Invalid chain ID, {cid}")
        if fname != GET_CHAIN_INFO and len(args) < 3:
            return error_response(f"missing 3rd argument for operation {fname}")
        if fname == GET_CHAIN_INFO:
            return self._chain_info(ledger)
        if fname == GET_BLOCK_BY_NUMBER:
            return self._block_by_number(ledger, args[2])
        if fname == GET_BLOCK_BY_HASH:
            return self._block_by_hash(ledger, args[2])
        if fname == GET_TRANSACTION_BY_ID:
            return self._tx_by_id(ledger, args[2])
        if fname == GET_BLOCK_BY_TX_ID:
            return self._block_by_txid(ledger, args[2])
        return error_response(f"Requested function {fname} not found.")

    def _chain_info(self, ledger) -> Response:
        info = {"height": ledger.height}
        store = ledger.block_store
        if ledger.height > 0:
            info["currentBlockHash"] = store.last_block_hash
            # absent on a snapshot-bootstrapped store with no blocks yet
            last = store.get_block_by_number(ledger.height - 1)
            if last is not None:
                info["previousBlockHash"] = last["header"].get("previous_hash", b"")
        return success(wire.encode(fabric.BLOCKCHAIN_INFO, info))

    def _block_by_number(self, ledger, arg: bytes) -> Response:
        try:
            number = int(arg.decode())
        except ValueError:
            return error_response(f"Failed to parse block number: {arg!r}")
        block = ledger.block_store.get_block_by_number(number)
        if block is None:
            return error_response(f"Fail to get block number {number}")
        return success(wire.encode(fabric.BLOCK, block))

    def _block_by_hash(self, ledger, block_hash: bytes) -> Response:
        block = ledger.block_store.get_block_by_hash(block_hash)
        if block is None:
            return error_response("Fail to get block by hash")
        return success(wire.encode(fabric.BLOCK, block))

    def _tx_by_id(self, ledger, arg: bytes) -> Response:
        txid = arg.decode()
        loc = ledger.block_store.get_tx_loc(txid)
        if loc is None:
            return error_response(f"Failed to get transaction with id {txid}")
        block_num, tx_num = loc
        if block_num < 0:
            # pre-snapshot txid: indexed for dedup only, block not stored
            return error_response(
                f"transaction {txid} committed before the ledger snapshot"
            )
        block = ledger.block_store.get_block_by_number(block_num)
        if block is None:
            return error_response(f"Fail to get block {block_num}")
        env = protoutil.get_envelope_from_block_data(block["data"]["data"][tx_num])
        flags = block["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER]
        pt = {
            "transactionEnvelope": {"payload": env.get("payload", b""),
                                    "signature": env.get("signature", b"")},
            "validationCode": flags[tx_num] if tx_num < len(flags) else 0,
        }
        return success(wire.encode(fabric.PROCESSED_TRANSACTION, pt))

    def _block_by_txid(self, ledger, arg: bytes) -> Response:
        loc = ledger.block_store.get_tx_loc(arg.decode())
        if loc is None:
            return error_response(f"Failed to get transaction with id {arg.decode()}")
        if loc[0] < 0:
            return error_response(
                f"transaction {arg.decode()} committed before the ledger snapshot"
            )
        block = ledger.block_store.get_block_by_number(loc[0])
        if block is None:
            return error_response(f"Fail to get block {loc[0]}")
        return success(wire.encode(fabric.BLOCK, block))
