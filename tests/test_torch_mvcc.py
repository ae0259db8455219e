"""The port's MVCC on the card (K5, K6 and their validators) against the JAX package.

(a) The plain versions `resolve_ref` / `resolve_resident_ref` against the
JAX package's jitted `_resolve` / `_resolve_resident` (XLA:CPU, compiled in
well under a second each) on the same seeded numpy columns, padded for JAX
as `DeviceValidator` pads them; `_resolve_resident` donates its table, so it
gets a fresh one each call. (b) `DeviceValidator(db, device="cpu")` and
`ResidentDeviceValidator(db, device="cpu")` against the JAX package's two
validators on one case per test of `tests/test_mvcc_device.py`, each block
built once as wire bytes and parsed by each package. All comparisons are
exact: masks, version tables, codes, update batches (items, versions,
values, metadata) and the route each block took.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu.common.txflags import TxValidationCode as JCode
from fabric_tpu.ledger import mvcc_device as jmd
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.ledger.mvcc import Validator as JValidator
from fabric_tpu.ledger.rwset_proto import serialize_tx_rwset as jserialize
from fabric_tpu.ledger.txparse import parse_tx_rwset as jparse
from fabric_tpu_torch.common.txflags import TxValidationCode
from fabric_tpu_torch.ledger import mvcc_device as md
from fabric_tpu_torch.ledger.statedb import VersionedDB
from fabric_tpu_torch.ledger.txparse import parse_tx_rwset as tparse
from test_torch_ledger import batch_dict, seeded_dbs

# ---------------------------------------------------------------------------
# (a) the plain versions against the JAX programs
# ---------------------------------------------------------------------------


def _columns(case):
    """Seeded read/write columns: (r_tx, r_key, r_bad, w_tx, w_key, T, K)."""
    if case == "alternating-chain":
        # tx i reads the key tx i-1 writes: validity alternates, T sweeps
        T = 64
        r_tx = np.arange(1, T)
        r_key = np.arange(0, T - 1)
        w_tx = np.arange(T)
        w_key = np.arange(T)
        return r_tx, r_key, np.zeros(T - 1, bool), w_tx, w_key, T, T
    if case == "edge":
        # keys with no writer, txs with no reads, duplicate writers of one
        # key, a tx writing one key twice, a statically bad read
        r_tx = np.array([1, 2, 2, 5, 6, 6])
        r_key = np.array([0, 3, 4, 1, 0, 2])
        r_bad = np.array([False, False, True, False, False, False])
        w_tx = np.array([0, 0, 0, 3, 4, 4, 6])
        w_key = np.array([0, 0, 1, 1, 1, 2, 0])
        return r_tx, r_key, r_bad, w_tx, w_key, 8, 6
    rng = np.random.default_rng(int(case.split("-")[1]))
    T = int(rng.integers(1, 200))
    K = int(rng.integers(1, 60))
    R = int(rng.integers(0, 3 * T))
    W = int(rng.integers(0, 3 * T))
    return (
        rng.integers(0, T, R), rng.integers(0, K, R), rng.random(R) < 0.1,
        rng.integers(0, T, W), rng.integers(0, K, W), T, K,
    )


def _pad(a, n, fill, dtype=np.int32):
    return jmd._col(list(a), n, fill, dtype=dtype)


RESOLVE_CASES = ["alternating-chain", "edge"] + [f"seed-{i}" for i in range(6)]


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_ref_matches_jax(case):
    r_tx, r_key, r_bad, w_tx, w_key, T, K = _columns(case)
    R, W = jmd._next_pow2(max(len(r_tx), 1)), jmd._next_pow2(max(len(w_tx), 1))
    Tb, Kb = jmd._next_pow2(T), jmd._next_pow2(K)
    want = np.asarray(jmd._resolve(
        _pad(r_tx, R, Tb), _pad(r_key, R, Kb), _pad(r_bad, R, 0, np.bool_),
        _pad(w_tx, W, Tb), _pad(w_key, W, Kb), num_txs=Tb, num_keys=Kb,
    ))[:T]
    before = dict(md.LAUNCHES)
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))  # noqa: E731
    valid, status = md.resolve(
        i32(r_tx), i32(r_key), torch.from_numpy(np.asarray(r_bad, bool)), i32(w_tx), i32(w_key), T, K
    )
    assert md.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert valid.tolist() == want.tolist()
    sweeps = md.converged_sweeps(status)
    assert 1 <= sweeps <= T + 1
    if case == "alternating-chain":
        assert sweeps == T and want.tolist() == [i % 2 == 0 for i in range(T)]


def _resident_columns(seed):
    """K6 columns: a table with some slots set, init indices (deduplicated,
    some at the drop sentinel), reads claiming right and wrong versions,
    writes whose version is a function of (tx, key) like the encoder's,
    some keys' slots at the drop sentinel."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(8, 64))
    T, K = int(rng.integers(1, 120)), int(rng.integers(1, 40))
    block = int(rng.integers(1, 50))
    gid = rng.permutation(cap + K)[:K]
    gid = np.where(gid >= cap, cap, gid)  # keys whose slot is dropped
    table = rng.integers(-1, 5, (cap, 2))
    n_init = int(rng.integers(0, cap))
    init_idx = np.concatenate([rng.permutation(cap)[:n_init], [cap]])
    init_ver = rng.integers(-1, 5, (len(init_idx), 2))
    R, W = int(rng.integers(0, 3 * T)), int(rng.integers(0, 3 * T))
    r_tx, r_key = rng.integers(0, T, R), rng.integers(0, K, R)
    truth = table.copy()
    keep = init_idx < cap
    truth[init_idx[keep]] = init_ver[keep]
    r_ver = truth[np.clip(gid[r_key], 0, cap - 1)].copy()
    wrong = rng.random(R) < 0.15
    r_ver[wrong] = [7, 7]
    w_tx, w_key = rng.integers(0, T, W), rng.integers(0, K, W)
    delete = (w_tx * 31 + w_key * 17) % 7 == 0
    w_ver = np.where(delete[:, None], -1, np.stack([np.full(W, block), w_tx], axis=1))
    return table, init_idx, init_ver, gid[r_key], r_ver, r_tx, r_key, w_tx, w_key, gid[w_key], w_ver, T, K


@pytest.mark.parametrize("seed", range(6))
def test_resolve_resident_ref_matches_jax(seed):
    (table, init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx, w_key, w_gid, w_ver, T,
     K) = _resident_columns(seed)
    cap = table.shape[0]
    R, W = jmd._next_pow2(max(len(r_tx), 1)), jmd._next_pow2(max(len(w_tx), 1))
    Ib = jmd._next_pow2(len(init_idx))
    Tb, Kb = jmd._next_pow2(T), jmd._next_pow2(K)

    def pad2(a, n):
        out = np.full((n, 2), -1, np.int32)
        out[: len(a)] = a
        return out

    want_valid, want_table = jmd._resolve_resident(
        jnp.asarray(table, dtype=jnp.int32),  # fresh: the program donates it
        _pad(init_idx, Ib, cap), pad2(init_ver, Ib), _pad(r_gid, R, cap), pad2(r_ver, R),
        _pad(r_tx, R, Tb), _pad(r_key, R, Kb), _pad(w_tx, W, Tb), _pad(w_key, W, Kb),
        _pad(w_gid, W, cap), pad2(w_ver, W), num_txs=Tb, num_keys=Kb, cap=cap,
    )
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    versions = i32(table)
    valid, status = md.resolve_resident(
        versions, i32(init_idx), i32(init_ver), i32(r_gid), i32(r_ver), i32(r_tx), i32(r_key),
        i32(w_tx), i32(w_key), i32(w_gid), i32(w_ver), T, K,
    )
    md.converged_sweeps(status)
    assert valid.tolist() == np.asarray(want_valid)[:T].tolist()
    assert versions.tolist() == np.asarray(want_table).tolist()  # updated in place


def test_resident_delete_wins_over_put_of_one_tx():
    """A tx that puts and deletes one key leaves it deleted, as the host
    oracle's write-set merge does; the JAX program's scatter order leaves
    this case undefined, so it is held to the rule alone."""
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    versions = i32([[0, 0], [0, 1]])
    valid, status = md.resolve_resident(
        versions, i32([]), i32([]).reshape(0, 2), i32([]), i32([]).reshape(0, 2), i32([]),
        i32([]), i32([0, 0, 0]), i32([0, 0, 1]), i32([0, 0, 1]),
        i32([[3, 0], [-1, -1], [3, 0]]), 1, 2,
    )
    assert md.converged_sweeps(status) == 1 and valid.tolist() == [True]
    assert versions.tolist() == [[-1, -1], [3, 0]]


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda a: a.to(torch.int64), TypeError),
        (lambda a: a[:-1], ValueError),
        (lambda a: torch.stack([a, a], 1)[:, 0], ValueError),
        (lambda a: a.to("meta"), ValueError),
    ],
    ids=["dtype", "shape", "contiguity", "device"],
)
def test_wrappers_reject_bad_inputs(change, error):
    col = torch.tensor([0, 1], dtype=torch.int32)
    bad = torch.tensor([False, False])
    with pytest.raises(error):
        md.resolve(change(col), col, bad, col, col, 2, 2)
    table = torch.zeros(4, 2, dtype=torch.int32)
    ver = torch.zeros(2, 2, dtype=torch.int32)
    e1, e2 = torch.zeros(0, dtype=torch.int32), torch.zeros(0, 2, dtype=torch.int32)
    with pytest.raises(error):
        md.resolve_resident(table, e1, e2, col, ver, col, col, change(col), col, col, ver, 2, 2)


def test_wrappers_raise_on_a_device_without_a_kernel():
    col = torch.tensor([0, 1], dtype=torch.int32, device="meta")
    bad = torch.tensor([False, False], device="meta")
    with pytest.raises(ValueError, match="no MVCC kernel"):
        md.resolve(col, col, bad, col, col, 2, 2)
    table = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    ver = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    e1 = torch.zeros(0, dtype=torch.int32, device="meta")
    e2 = torch.zeros(0, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no MVCC kernel"):
        md.resolve_resident(table, e1, e2, col, ver, col, col, col, col, col, ver, 2, 2)


def test_out_of_range_index_raises():
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    _valid, status = md.resolve(i32([3]), i32([0]), torch.tensor([False]), i32([0]), i32([0]), 2, 1)
    with pytest.raises(ValueError, match="outside"):
        md.converged_sweeps(status)


def test_validators_need_a_card():
    """Entry points run on cuda unless asked for the CPU; with no card they
    raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        md.DeviceValidator(VersionedDB())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        md.ResidentDeviceValidator(VersionedDB())
    with pytest.raises(ValueError):
        md.DeviceValidator(VersionedDB(), device="meta")


def test_resident_device_failure_raises_and_drops_the_table(monkeypatch):
    """The port's departure from the JAX package: a failed dispatch is not
    served from the host oracle. The table (updated in place) is dropped and
    the error propagates."""
    _, db = seeded_dbs()
    res = md.ResidentDeviceValidator(db, device="cpu")
    block = [tparse(jserialize(_tx(reads=[("k0", (0, 0))], writes=["k0"])))]
    codes, _u, _h = res.validate_and_prepare_batch(1, block, [TxValidationCode.VALID])
    assert res.last_path == "device" and res.slots_used == 1

    def fail(*args, **kwargs):
        raise RuntimeError("launch failed: cudaError 700")

    monkeypatch.setattr(md, "resolve_resident", fail)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        res.validate_and_prepare_batch(2, block, [TxValidationCode.VALID])
    assert res.slots_used == 0 and res._dev_versions is None


# ---------------------------------------------------------------------------
# (b) the validators against the JAX package's
# ---------------------------------------------------------------------------

VALID = JCode.VALID


def _tx(reads=(), writes=(), deletes=(), hreads=(), hwrites=(), coll="coll0", rqs=(), md_writes=()):
    """A JAX TxRwSet in namespace "cc"; versions are (block, tx) pairs or None."""
    ver = lambda v: None if v is None else jrw.Version(*v)  # noqa: E731
    colls = ()
    if hreads or hwrites:
        colls = (jrw.CollHashedRwSet(
            coll,
            tuple(jrw.KVReadHash(k, ver(v)) for k, v in hreads),
            tuple(jrw.KVWriteHash(k, False, b"\x02" * 32) for k in hwrites),
        ),)
    return jrw.TxRwSet((jrw.NsRwSet(
        "cc",
        tuple(jrw.KVRead(k, ver(v)) for k, v in reads),
        tuple(jrw.KVWrite(k, False, b"v1") for k in writes)
        + tuple(jrw.KVWrite(k, True) for k in deletes),
        tuple(rqs), colls, tuple(md_writes),
    ),))


def _case_blocks(name, jdb):
    """The blocks of a test_mvcc_device case as [(block_num, rwsets, codes)];
    callable per block so a case can read the evolving state."""
    if name == "basic_conflicts":
        yield 7, [
            _tx(reads=[("k0", (0, 0))], writes=["k0"]),
            _tx(reads=[("k0", (0, 0))], writes=["k5"]),
            _tx(reads=[("k9", (0, 3))], writes=["k9"]),
            _tx(writes=["k30"]),
            _tx(reads=[("k5", (0, 5))]),
        ], [VALID] * 5
    elif name == "alternating_chain":
        yield 3, [
            _tx(reads=[(f"k{i - 1}", (0, i - 1))] if i else [], writes=[f"k{i}"]) for i in range(24)
        ], [VALID] * 24
    elif name == "deletes":
        yield 2, [_tx(deletes=["k2"]), _tx(reads=[("k2", (0, 2))])], [VALID] * 2
    elif name == "hashed_reads_and_writes":
        yield 4, [
            _tx(hreads=[(b"h0", (0, 0))], hwrites=[b"h1"]),
            _tx(hreads=[(b"h1", (0, 1))]),
            _tx(hreads=[(b"h1", (0, 1))], coll="coll1"),
        ], [VALID] * 3
    elif name == "incoming_invalid_and_none":
        yield 1, [_tx(writes=["k0"]), None, _tx(reads=[("k0", (0, 0))])], [
            JCode.BAD_CREATOR_SIGNATURE, VALID, VALID,
        ]
    elif name == "range_query_host_route":
        rq = jrw.RangeQueryInfo("k0", "k3", True, tuple(
            jrw.KVRead(f"k{i}", jrw.Version(0, i)) for i in range(3)
        ))
        yield 1, [_tx(writes=["k0"], rqs=[rq])], [VALID]
    elif name == "metadata_write_host_route":
        yield 1, [_tx(writes=["k0"], md_writes=[jrw.KVMetadataWrite("k0", (("owner", b"org1"),))])], [VALID]
    elif name == "randomized_blocks":
        rng = random.Random(20260731)
        for trial in range(8):
            n = rng.randrange(1, 60)
            rwsets, incoming = [], []
            for t in range(n):
                if rng.random() < 0.05:
                    rwsets.append(None)
                    incoming.append(VALID)
                    continue
                incoming.append(VALID if rng.random() < 0.9 else JCode.ENDORSEMENT_POLICY_FAILURE)
                reads = []
                for _ in range(rng.randrange(0, 4)):
                    i = rng.randrange(30)
                    roll = rng.random()
                    v = (0, i) if roll < 0.7 else (0, i + 1) if roll < 0.85 else None
                    reads.append((f"k{i}", v))
                writes, deletes = [], []
                for _ in range(rng.randrange(0, 4)):
                    (deletes if rng.random() < 0.2 else writes).append(f"k{rng.randrange(35)}")
                hreads, hwrites = [], []
                coll = f"coll{rng.randrange(2)}"
                if rng.random() < 0.3:
                    for _ in range(rng.randrange(0, 3)):
                        i = rng.randrange(15)
                        hreads.append((f"h{i}".encode(), (0, i) if rng.random() < 0.8 else None))
                    for _ in range(rng.randrange(0, 3)):
                        hwrites.append(f"h{rng.randrange(18)}".encode())
                rwsets.append(_tx(reads, writes, deletes, hreads, hwrites, coll))
            yield trial + 1, rwsets, incoming
    elif name == "resident_multi_block_sequence":
        rng = random.Random(42)
        for block_num in range(1, 8):
            rwsets = []
            for _t in range(12):
                reads, writes, deletes = [], [], []
                for _ in range(rng.randrange(3)):
                    i = rng.randrange(50)
                    committed = jdb.get_version("cc", f"k{i}")
                    claim = committed if rng.random() < 0.7 else jrw.Version(9, 9)
                    reads.append((f"k{i}", None if claim is None else (claim.block_num, claim.tx_num)))
                for _ in range(rng.randrange(3)):
                    (deletes if rng.random() < 0.15 else writes).append(f"k{rng.randrange(50)}")
                hreads, hwrites = [], []
                if rng.random() < 0.3:
                    hi = rng.randrange(25)
                    hk = f"h{hi}".encode()
                    v = jdb.get_key_hash_version("cc", "coll0", hk)
                    hreads, hwrites = [(hk, None if v is None else (v.block_num, v.tx_num))], [hk]
                rwsets.append(_tx(reads, writes, deletes, hreads, hwrites))
            yield block_num, rwsets, [VALID] * len(rwsets)
    elif name == "resident_capacity_growth":
        for block_num in (1, 2):
            rwsets = []
            for t in range(20):
                i = (block_num * 20 + t * 3) % 70
                v = jdb.get_version("cc", f"k{i}")
                rwsets.append(_tx(reads=[(f"k{i}", None if v is None else (v.block_num, v.tx_num))],
                                  writes=[f"k{(i + 1) % 70}"]))
            yield block_num, rwsets, [VALID] * len(rwsets)
    elif name == "resident_host_route_refresh":
        yield 1, [_tx(reads=[("k0", (0, 0))], writes=["k0"])], [VALID]
        yield 2, [_tx(writes=["k0"], md_writes=[jrw.KVMetadataWrite("k30", (("p", b"x"),))])], [VALID]
        yield 3, [_tx(reads=[("k0", (2, 0))]), _tx(reads=[("k0", (1, 0))])], [VALID, VALID]
    elif name == "resident_aborted_encode":
        yield 1, [
            _tx(reads=[("k5", (0, 5))]),
            _tx(md_writes=[jrw.KVMetadataWrite("k9", (("p", b"x"),))]),
        ], [VALID, VALID]
        yield 2, [_tx(reads=[("k5", (0, 5))]), _tx(reads=[("k5", (7, 7))])], [VALID, VALID]


# (case, validator kind, keys seeded, resident capacity)
VALIDATOR_CASES = [
    (name, kind, 40, 1 << 17)
    for name in (
        "basic_conflicts", "alternating_chain", "deletes", "hashed_reads_and_writes",
        "incoming_invalid_and_none", "range_query_host_route", "metadata_write_host_route",
    )
    for kind in ("device", "resident")
] + [
    ("alternating_chain", "resident", 64, 1 << 17),
    ("randomized_blocks", "device", 30, 1 << 17),
    ("randomized_blocks", "resident", 30, 1 << 17),
    ("resident_multi_block_sequence", "resident", 40, 64),
    ("resident_capacity_growth", "resident", 70, 8),
    ("resident_host_route_refresh", "resident", 40, 1 << 17),
    ("resident_aborted_encode", "resident", 40, 1 << 17),
]


@pytest.mark.parametrize(
    "name,kind,n_keys,capacity", VALIDATOR_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in VALIDATOR_CASES],
)
def test_validator_matches_jax(name, kind, n_keys, capacity):
    jdb, tdb = seeded_dbs(n_keys=n_keys)
    if kind == "device":
        jval, tval = jmd.DeviceValidator(jdb), md.DeviceValidator(tdb, device="cpu")
    else:
        jval = jmd.ResidentDeviceValidator(jdb, capacity=capacity)
        tval = md.ResidentDeviceValidator(tdb, capacity=capacity, device="cpu")
    chains = kind == "resident"  # a resident validator sees one evolving state
    for block_num, rwsets, codes in _case_blocks(name, jdb):
        raw = [None if r is None else jserialize(r) for r in rwsets]
        jset = [None if b is None else jparse(b) for b in raw]
        tset = [None if b is None else tparse(b) for b in raw]
        want = jval.validate_and_prepare_batch(block_num, jset, list(codes))
        got = tval.validate_and_prepare_batch(
            block_num, tset, [TxValidationCode(int(c)) for c in codes]
        )
        assert [int(c) for c in got[0]] == [int(c) for c in want[0]]
        assert batch_dict(got[1]) == batch_dict(want[1])
        assert batch_dict(got[2]) == batch_dict(want[2])
        assert tval.last_path == jval.last_path
        host = JValidator(jdb).validate_and_prepare_batch(block_num, jset, list(codes))
        assert [int(c) for c in host[0]] == [int(c) for c in want[0]]
        if chains:
            jdb.apply_updates(want[1], hashed=want[2])
            tdb.apply_updates(got[1], hashed=got[2])
        if kind == "device" and name not in ("range_query_host_route", "metadata_write_host_route"):
            assert tval.last_path == "device" and tval.last_sweeps >= 1
    if kind == "resident":
        assert tval.capacity == jval._cap >= tval.slots_used == len(jval._index)
