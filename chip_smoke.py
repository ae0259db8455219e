#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fabric_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the kernels from csrc/ with nvcc (one compiler per source, all
started together), holds each against its plain PyTorch version on the
card, then drives the port's paths at the sizes Fabric feeds them.

The CUDAProvider behind the BCCSP SPI (P-256 verify, K1, K2 and the
key-comb kernel, csrc/p256_verify.cu; `p256_phases`):

  1. kernel vs plain version, K1 (limbs) and K2 (bytes), 64 lanes with the
     edge lanes of `p256_crafted_lanes`: masks bit-identical, and equal to
     the oracle's; the key-comb kernel word for word;
  2. headline: 32,768 lanes from 8 keys (bytes route), 3 timed passes of
     2 batches in flight;
  3. block batch: 3,000 lanes from 3 keys (the signature phase of a
     1,000-tx block under a 2-of-3 policy);
  4. limb route: 4,096 lanes from 64 keys (past the 32-column key bucket),
     and a 1,024-lane batch with all 32 key columns in use;
  5. launch counts of the main path (phases 2-4; the provider builds a
     key's comb once and keeps it by SKI), then each kernel's own time
     (CUDA events), the key-comb kernel's alone at the block's keys and at
     32 with its split from its clock stamps (`key_table_probe`: the
     doubling chain, a doubling's cycles and the steps of one, the fill
     left after the chain) and its words against the plain version at
     both, the plain versions' at the headline, limb and 32-key shapes,
     and each bound: bound_ms (the least work known), bound_ms_kernel,
     bound_ms_replaced.

The ledger's commit-time MVCC (K5 and K6, csrc/mvcc_resolve.cu):

  6. mvcc_kernel_vs_plain: both K5 routes and both K6 routes (shared
     memory, global memory; mvcc_device.resolve_route and resident_route
     pick one by size) against their plain versions on seeded columns with
     a 64-tx alternating chain, keys with no writer, txs with no reads,
     duplicate writers, deletes and drop-sentinel indices; a seeded block
     past K5's shared limit (13,000 reads) and one past K6's (19,400 keys),
     each taking its global route, which the shared route refuses;
  7. mvcc_5k: BASELINE config #4 (bench.py bench_mvcc), a 5,000-tx block
     through serialize -> parse -> DeviceValidator: codes and updates equal
     to the host oracle's, 500 conflicts, K5's shared route; then the same
     block shape at 13,000 txs, past K5's shared route, through K5's global
     route; both routes held to the plain version at both shapes, timed in
     turns at config #4 and the global route at 13,000 txs, the shared
     route's time split from its clock stamps (`k5_probe`);
  8. mvcc_resident_5k: config #4's resident blocks (bench.py bench_mvcc,
     its resident variant), 4 blocks through kvledger.commit_block_state
     with a ResidentDeviceValidator against a second state DB behind the
     host oracle: codes, update batches and the chained commit hash equal,
     500 conflicts a block; K6's time and bound are taken at block 4, in
     the steady state, where both routes are held to the plain version and
     timed, the route taken printed and counted, and the shared route's
     time split from its clock stamps (`k6_probe`);
  9. mvcc_resident_chain, a correctness and capacity check: 20 blocks of
     5,000 Zipf-skewed txs over 1,000,000 committed keys, held to the host
     oracle block by block as in 8; blocks 7 (range query) and 13 (metadata
     write) take the host route, a generation bump before block 16 drops
     and rebuilds the table, and K6 launches 18 times; its last block
     held, timed and split as block 4 of 8;
 10. each kernel's time at its main-path shapes, its plain version's time
     and its bound; a route of a kernel is an entry of its own.

Idemix batch verification of BASELINE config #3 (K3 and K4, csrc/bn256.cu):

 11. idemix_kernel_vs_plain: K3 (the G1 MSM) at K = 8 over edge lanes
     (identity bases, zero scalars, e = 1, e = r - 1, r * G = O, equal
     bases, random), its points lane by lane against the plain version's
     and the host oracle's (the kernel sums in another order, so its
     projective words differ), four of them widened to K = 33 (a warp a
     lane, thread 0 with a second base) against the host oracle, and K4
     (the Ate2 pairing check) at 8 lanes (true, false, None, identity
     ABar), every output word against the
     plain version, the Miller values and final-exponentiated values
     included;
 12. idemix_config3: bench.py's config #3 (8 unique signatures from
     random.Random(1234), every attribute hidden, an unsigned
     ALG_NO_REVOCATION CRI) tiled to 64 and 256 signatures through
     verify_signatures_batch: masks all True and equal to the scheme
     oracle, ms per signature, the host/K4/K3/challenge split, each
     kernel's time, the host's MSM packing and affine conversion at 256
     signatures timed alone, the oracle's ms per signature over 4
     signatures;
 13. idemix_mask: a mixed batch (wrong message, proof_s_sk + 1, a wrong
     disclosed value, ABar doubled, ABar and A' the identity, a wrong count
     of s-values) held lane by lane to the scheme oracle; idemix_wide: a
     13-attribute key (t2's MSM lane has 17 bases, a warp a lane in one K3
     launch), its verdicts equal to the scheme oracle's;

Block validation of BASELINE config #2 and the policy circuit (K7,
csrc/policy_eval.cu; K2 and K6 on the validator's path):

 14. policy_kernel_vs_plain: K7 against its plain version and the host
     oracle on tests/test_policy.py's exhaustive and random policies and on
     edge lanes (S in {31, 32, 33, 64, 65, 100}, n = 0, n above the child
     count, NOutOf with no children, failing branches that claimed signers,
     depth 23, B = 1), each case on the route its shape picks
     (policy_kernel.policy_route: the shared route up to 32 signers, the
     global route past it) and on each route that takes it; B = 0 launches nothing;
 15. validator_config2: bench.py's config #2 (Org1-3 minted by the port's
     cryptogen, a 1,000-tx block of 3,000 signature lanes from 3 keys under
     OutOf(2, ...)) through BlockValidator over CUDAProvider, a warm-up and
     5 timed runs on fresh validators: all VALID, K2 once a block, ms per
     block and its split; then K7 through compile_batched on the block's
     1,000 satisfaction rows (the shared route) and on the same rows in a
     batch 33 signers wide (the global route), verdicts equal to the flags and
     the plain version, both routes timed in turns at the block's shape;
 16. validator_mask: 70 txs of ten kinds (valid, flipped creator signature,
     flipped endorsement, unknown MSP, unknown chaincode, bad txid, in-block
     duplicate, nil envelope, unparseable payload, a CRL-revoked endorser),
     the flags lane by lane equal to the codes the JAX validator gives
     (tests/test_torch_validator.py) and to the oracle provider's;
 17. validator_commit: three config #2 blocks validated and committed
     through kvledger.commit_block_state with a ResidentDeviceValidator
     (K6), commit hashes equal to the host route's on a second state DB;
 18. native and multichannel_config5: the native host runtime against the
     Python routes, and bench.py's config #5 through MultiChannelValidator
     (one K1 launch a validate);

The peer's commit path (CommitPipeline, Channel, the shared VerifyBatcher,
the persistent KVLedger; K2, the key-comb kernel and K5 on its path):

 19. pipeline_config2: 10 linked config #2 blocks of 1,000 txs (block 5 with
     100 of config #4's read conflicts), signed in a pool of spawned
     processes, through Channel(BatchingProvider(CUDAProvider), device_mvcc=
     True) and CommitPipeline(depth=2) from a deliver thread over a
     persistent ledger under build/smoke_ledgers/; the same chain stored one
     block at a time over CUDAProvider (K5) and over the host MVCC (the
     reference); filters, commit hashes, .chain bytes and SQLite rows equal
     in all three, block 5's 100 conflicts and nothing else invalid, K5 once
     a block on its device route, K2 at least once and at most once a
     block, the key combs once, no dispatch retry and no fail-closed
     settlement (the port's fabobs counters), a reopen at height 10 with
     nothing replayed; the oracle on a seeded sample of each block's
     signature lanes; tx/s, stage_stats, the overlap share, each block's
     commit split and the full GC collections;
 20. pipeline_config5: four config #5 channels (2 blocks of 2,000 txs
     each), each with its own CommitPipeline, ledger and deliver thread,
     sharing one BatchingProvider: each channel's filters and commit hashes
     equal to the channel stored alone, aggregate tx/s, the batcher's
     launches against the 8 blocks submitted;
 21. snapshot_config2: join by snapshot. Two ledgers seeded alike before
     block 0 with mvcc_resident_chain's state (1,000,000 public and 50,000
     hashed keys) and benchcc's committed `_lifecycle` definition (the
     "guard" validation plugin, coll0): A commits pipeline_config2's chain
     pipelined (K2, K5) with a snapshot taken after block 4, A' commits
     blocks 0-4 one at a time (host MVCC) and snapshots too; the snapshots
     equal byte for byte. Peer J joins from A's snapshot and commits blocks
     5-9 pipelined through BatchingProvider(CUDAProvider) (K2, the key
     combs) and K5, its definitions read through ValidationRouter /
     LifecycleRegistry from the state the snapshot carried and its txs
     validated by the "guard" plugin; peer J' joins from A''s and commits
     them one at a time (static registry, host MVCC). J's filters equal
     J''s, A's and the expected codes; J's and J''s commit hashes, .chain
     and SQLite rows are equal; J's frames are A's but for the COMMIT_HASH
     slot (the hash chain restarts at a join); J's state rows equal A's;
     the plugin saw exactly K2's refused endorsement lanes, once a tx; K2's
     lanes held as in 19; J's history of 8 keys is A's after the join; a
     block-2 tx resubmitted is DUPLICATE_TXID on J and J' (.pretxids);
 22. config_update_config2: channel configuration on the peer. The
     genesis block from the port's encoder (a solo orderer org, Org1-3,
     the sample policies, the default ACLs) committed as the JAX peer's join
     commits it; pipeline_config2's envelopes as blocks 1-4 and 6-10 (block
     4 with 10 txs of Org4's client, refused: Org4 is unknown); block 5 a
     CONFIG block whose update adds Org4MSP and overrides event/Block to
     Writers, signed by Org1's and Org2's admins, in the ConfigEnvelope the
     orderer's Validator proposes and the orderer signs; blocks 7-10 each
     with 10 Org4 txs, VALID. The apply_config callback decodes, validates
     (the admin signatures through the policy manager and K2) and builds
     the new Bundle, whose MSP manager the validator takes. Pipelined
     (BatchingProvider(CUDAProvider), K2, the key combs, K5; a drain after
     the CONFIG block) and one block at a time: filters, commit hashes,
     .chain and SQLite rows equal, the expected codes, bundle sequence 1.
     Beside the path: an update signed by Org1's admin alone, one with a
     flipped admin signature (K2 refuses that lane) and one with a stale
     read set, each refused; 1,010 peer/Propose checks (block 4's txs) and 6
     event/Block checks through ACLProvider before the update and after
     block 10, Org4 denied then allowed, each verdict equal to the same
     check over the oracle; K2's lanes held as in 19 (every admin lane),
     the plain version only for a launch wider than 4,096 padded lanes;
 23. factory_config2: the peer's BCCSP built by crypto/factory from the
     config block (Default CUDA, SW ECBackend auto and IdemixBackend
     hostbn): a CUDAProvider on the card, with
     Default SW a SoftwareProvider on hostec_np; a pinned fastec and a
     PKCS#11 library that does not exist are FactoryErrors. Config #2's
     block and the mask block through BlockValidator over each (warm-up and
     timed run), the filters equal and equal to the expected codes; the
     hostec_np pool's workers import no torch. Every lane K2 verified or
     refused on pipeline_config2 and pipeline_config5 held against
     SoftwareProvider(hostec_np), lane by lane through a memo; 31 lanes
     through CUDAProvider.batch_verify one K2 launch, equal to the oracle,
     2 and 31 lanes timed over K2 and over SoftwareProvider in turns (3 runs
     each); verify() one K2 launch, on bad DER and high-S a VerifyError with no
     launch; config #3's 256 signatures and the mixed batch through the
     device route (K4, K3) and the hostbn rung, masks equal, ms a signature
     for each; no host pool degraded, the pools shut down;
 24. serve_config2: config #2 verified through the serve sidecar
     (fabric_tpu_torch.serve). An in-process SidecarServer on the card's
     CUDAProvider warmed on the `verify` ladder (K1 at each of 128-16,384
     lanes; a 32,768-lane request's bucket never warmed, the registry
     raising on it), reached through the factory's SERVE rung: config #2's
     block and the mask block through BlockValidator, filters equal to the
     in-process CUDAProvider's and the expected codes, the server's K2
     counter moving and this process's not; pipeline_config2's chain
     through Channel/CommitPipeline over the sidecar (K5 in process),
     filters and commit hashes equal to pipeline_config2's; 2, 31, 4,096 and
     32,768 lanes 20 times each through the sidecar and in process, in
     turns; four clients (high, normal, two bulk) pipelining 25 requests of
     256-4,096 lanes each against a 16,384-lane budget (busy rejects by
     class, K2 launches against requests, the server's latencies); a
     3,000-lane request with 10 NO_KEY lanes and 5 under undecodable keys,
     those False; a daemon (`python -m fabric_tpu_torch.serve`, exec'd)
     answering its first PING (seconds from start, its build-cache loads),
     SIGKILLed with 32,768 lanes in flight, the batch rescued on this
     process's CUDAProvider (its K2 moving, the client alone degraded,
     fabric_degrade_total{seam="serve.client"} 1); two sidecars behind a
     SidecarRouter, one drained and restarted at its address under 40
     requests, no rescue, both serving. Every mask against factory_config2's
     hostec_np memo;
 25. idemix_msp: the Idemix MSP. The port's idemixgen (`ca_keygen`, then
     `signerconfig` an identity) writes an issuer and 16 signer identities
     (4 OUs, MEMBER and ADMIN, the tool's roles) under build/smoke_idemix/,
     plus a CLIENT- and a PEER-mask credential and another issuer's
     identity; IdemixMSP loads the directory. In a pool of spawned
     processes (one a core, at most 8) each identity is made, deserialized,
     validated on the host, checked with satisfies_principal against a
     matching and a non-matching ROLE and OU principal, and signs a message
     (verified there and here, and refused on another message). The 16
     association proofs tiled to config #3's 256 lanes (disclosure
     [1,1,0,0], the empty message, the OU's hash and the role disclosed)
     through verify_signatures_batch on the card (K4, K3), 3 times: all
     True; a batch of 8 lanes (a member, an admin, a flipped proof byte, a
     claimed ADMIN role, a claimed OU, another issuer's identity, the CLIENT-
     and PEER-mask credentials, whose proofs disclose MEMBER's mask as in
     the reference) equal to the host validate lane by lane; the CRI's
     P-384 signature verified and a flipped one refused; a weak
     Boneh-Boyen signature verified and refused on another message;
 26. mesh_sharded: the multi-device wrappers over the card listed 4 times.
     ShardedVerify.verify_flat at the headline's 32,768 lanes over
     flat_mesh() (1 K1 launch a card) and over the 4-times mesh (4, a stream
     each), beside the unsharded K1 call, in turns; MeshCUDAProvider:
     config #2's block through BlockValidator (one K2 launch, unsharded, as
     the reference's batch_verify) and _run_kernel on the limb route's
     4,096 lanes (4 K1 launches); MultiChannelValidator over grid_mesh(4, 1)
     on config #5's four channels (4 K1 launches a validate) beside the
     unsharded one; Ate2Kernel.check_sharded at config #3's 256 lanes (4
     K4 launches) beside check. Every mask and flag byte equal to the
     unsharded call's and the oracle's; K1 alone at 32,768 lanes and at a
     quarter of them; on a host with several cards, each form again over
     meshes of distinct cards, every launch on its position's card;
 27. endorse_config2: Fabric's transaction flow at config #2's width.
     Org1's client signs 3,008 proposals of benchcc; Org1's and Org2's
     peers each check the creator (Identity.verify: one K2 launch of one
     lane), simulate over their committed state and sign; the client's
     envelopes go to a SoloChain that cuts and signs 1,000-tx blocks into
     both peers' CommitPipelines (the orderer's signature through
     block_signature_verifier, K2, the key combs, K5). 8 proposals refused
     by both endorsers, 100 MVCC_READ_CONFLICT, 4
     ENDORSEMENT_POLICY_FAILURE; both peers, the expected codes and a
     serial host-MVCC ledger equal; qscc's answers against the ledger;
     every K2 lane against hostec_np. The smoke also prints whether grpc and
     yaml import (the `modules` line, after the build);
 28. the launch floor (a kernel that does nothing, timed as the kernels
     are), the kernels line with it as floor_ms, then the card's name and
     power limit.

Signature inputs are signed by the port's oracle with fixed keys and
nonces, a known subset corrupted (flipped digest, wrong key, s+1, high-S,
bad DER, r = 0, r = n, off-curve key); the expected masks come from the
oracle. MVCC inputs come from fixed numpy seeds, Idemix inputs from
random.Random seeds. Any
mismatch or error exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import gc
import hashlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED_PRIV = 0xC2B2AE3D27D4EB4F
SEED_NONCE = 12345
# H100 memory rate for the byte bound (NVIDIA data sheet, SXM part)
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds per SM per clock on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
IMAD_PER_SM_PER_CLOCK = 64


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# MVCC (K5, K6): the ledger's commit-time validate-and-prepare
# ---------------------------------------------------------------------------

MVCC_SEED = 20261017
MVCC_TXS = 5000  # BASELINE config #4's block (bench.py bench_mvcc)
RESIDENT_BLOCKS = 4  # block 1 seeds the table; 2-4 are the steady state
CHAIN_BLOCKS = 20
CHAIN_KEYS = 1_000_000
CHAIN_HASHED_KEYS = 50_000
ZIPF_S = 1.1
# K5's and K6's two kernels each, chosen by a block's size
# (mvcc_device.resolve_route, resident_route)
K5_ROUTES = ("mvcc_resolve", "mvcc_resolve_global")
K6_ROUTES = ("mvcc_resolve_resident", "mvcc_resolve_resident_global")
# config #4's block shape past K5's shared route (12,288 reads)
PAST_K5_TXS = 13_000


def k6_launches(md) -> dict:
    return {r: md.LAUNCHES[r] for r in K6_ROUTES}


def k5_launches(md) -> dict:
    return {r: md.LAUNCHES[r] for r in K5_ROUTES}


def mvcc_kernel_cases(np):
    """Seeded K5 and K6 columns with the edge cases: an alternating
    invalidation chain of 64 txs, keys with no writer, txs with no reads,
    duplicate writers of one key, a tx writing one key twice, statically
    bad reads; for K6 also deletes, init and write indices at the drop
    sentinel (cap), and reads claiming wrong versions."""
    rng = np.random.default_rng(MVCC_SEED)
    T, K = 300, 220
    r_tx, r_key, w_tx, w_key = [], [], [], []
    for i in range(64):  # the chain: tx i reads what tx i-1 writes
        w_tx.append(i)
        w_key.append(i)
        if i:
            r_tx.append(i)
            r_key.append(i - 1)
    for t in range(100, 110):  # keys 100-109 have no writer
        r_tx.append(t)
        r_key.append(t)
    for t in range(120, 130):  # ten writers of key 150, one writing it twice
        w_tx += [t, t] if t == 125 else [t]
        w_key += [150, 150] if t == 125 else [150]
        r_tx.append(t + 10)
        r_key.append(150)
    n = 600  # random traffic over the rest; txs 64-99 read nothing
    r_tx += list(rng.integers(140, T, n))
    r_key += list(rng.integers(0, K, n))
    w_tx += list(rng.integers(140, T, n))
    w_key += list(rng.integers(151, K, n))
    r_bad = rng.random(len(r_tx)) < 0.05
    r_bad[:63] = False  # keep the chain whole
    k5 = (np.array(r_tx), np.array(r_key), r_bad, np.array(w_tx), np.array(w_key), T, K)

    cap = 256
    gid = rng.permutation(cap)[:K]
    gid[rng.random(K) < 0.05] = cap  # writes to these keys are dropped
    table = rng.integers(-1, 6, (cap, 2))
    init_idx = np.concatenate([rng.permutation(cap)[:40], [cap, cap + 7]])
    init_ver = rng.integers(-1, 6, (len(init_idx), 2))
    truth = table.copy()
    keep = init_idx < cap
    truth[init_idx[keep]] = init_ver[keep]
    r_gid = gid[k5[1]]
    r_ver = truth[np.clip(r_gid, 0, cap - 1)].copy()
    r_ver[r_bad] = (9, 9)
    w_tx_a, w_key_a = k5[3], k5[4]
    delete = rng.random(len(w_tx_a)) < 0.1
    twice = np.flatnonzero(w_tx_a == 125)  # tx 125 puts key 150, then deletes it
    delete[twice] = [False, True]
    w_ver = np.stack([np.full(len(w_tx_a), 3), w_tx_a], axis=1)
    w_ver[delete] = -1  # a tx's lanes on one key differ only by a delete
    k6 = (table, init_idx, init_ver, r_gid, r_ver, k5[0], k5[1], w_tx_a, w_key_a,
          gid[w_key_a], w_ver, T, K)
    return k5, k6


def mvcc_random_case(np, rng, T, K, R, W, cap, zipf=None):
    """Seeded K6 columns over K keys (uniform, or Zipf(s = zipf) like the
    resident chain's): 5% of reads stale, 5% of writes deletes, 2% of
    slots at the drop sentinel, a tenth of the keys seeded by the launch.
    Zipf keys are renumbered to those the block touches, as the validators'
    encoders number them; uniform ones keep the range K. Returns
    resolve_resident's arguments and T, K."""
    def keys(n):
        if zipf is None:
            return rng.integers(0, K, n)
        w = 1.0 / np.arange(1, K + 1, dtype=np.float64) ** zipf
        return np.minimum(np.searchsorted(np.cumsum(w) / w.sum(), rng.random(n)), K - 1)

    gid = rng.permutation(cap)[:K]
    gid[rng.random(K) < 0.02] = cap
    table = rng.integers(-1, 6, (cap, 2))
    init_idx = rng.permutation(cap)[:K // 10]
    init_ver = rng.integers(-1, 6, (len(init_idx), 2))
    truth = table.copy()
    truth[init_idx] = init_ver
    r_tx, r_key = np.sort(rng.integers(0, T, R)), keys(R)
    r_ver = truth[np.clip(gid[r_key], 0, cap - 1)].copy()
    r_ver[rng.random(R) < 0.05] = (9, 9)
    w_tx, w_key = np.sort(rng.integers(0, T, W)), keys(W)
    w_ver = np.stack([np.full(W, 3), w_tx], axis=1)
    w_ver[rng.random(W) < 0.05] = -1
    r_gid, w_gid = gid[r_key], gid[w_key]
    if zipf is not None:
        used, ids = np.unique(np.concatenate([r_key, w_key]), return_inverse=True)
        r_key, w_key, K = ids[:R], ids[R:], len(used)
    return (table, init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx, w_key, w_gid, w_ver,
            T, K)


def mvcc_config4_rwsets(rw, n_txs=MVCC_TXS, ver=None):
    """bench.py bench_mvcc: every tx reads its own key at the committed
    version and writes it; every 10th (i % 10 == 5) reads its neighbour's
    key, which the neighbour already wrote: 500 MVCC_READ_CONFLICT. `ver`
    maps key i to its committed version (the resident blocks' bookkeeping);
    without it every key is at (0, i)."""
    out = []
    for i in range(n_txs):
        rk = i - 1 if i % 10 == 5 else i
        read_ver = rw.Version(*ver[rk]) if ver is not None else rw.Version(0, rk)
        out.append(rw.TxRwSet((rw.NsRwSet(
            "cc", (rw.KVRead(f"k{rk}", read_ver),), (rw.KVWrite(f"k{i}", False, b"v1"),),
        ),)))
    return out


def batches_as_values(batch):
    return {k: (e.value, (e.version.block_num, e.version.tx_num), e.metadata)
            for k, e in batch.items()}


class ChainTraffic:
    """The resident chain's blocks: per tx 2 reads and 2 writes drawn Zipf
    (s = 1.1) over the 1,000,000 public keys, 10% of txs with one hashed
    read and write (Zipf over the 50,000 hashed keys), 5% of writes deletes,
    5% of txs arriving with another code than VALID; reads claim the
    version committed as of the previous block."""

    def __init__(self, np, rw, TxValidationCode):
        self.np, self.rw, self.codes = np, rw, TxValidationCode
        self.rng = np.random.default_rng(MVCC_SEED + 1)

        def zipf_cdf(n):
            w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** ZIPF_S
            return np.cumsum(w) / w.sum()

        self.cdf = zipf_cdf(CHAIN_KEYS)
        self.hcdf = zipf_cdf(CHAIN_HASHED_KEYS)
        # hot ranks land anywhere in the key space
        self.perm = self.rng.permutation(CHAIN_KEYS)
        self.hperm = self.rng.permutation(CHAIN_HASHED_KEYS)

    @staticmethod
    def key(i: int) -> str:
        return f"k{i:07d}"

    @staticmethod
    def key_hash(i: int) -> bytes:
        return hashlib.sha256(b"h%d" % i).digest()

    def draw(self, cdf, perm, n):
        ranks = self.np.minimum(self.np.searchsorted(cdf, self.rng.random(n)), len(cdf) - 1)
        return perm[ranks]

    def block(self, number: int, db, n_txs=MVCC_TXS):
        np, rw, codes = self.np, self.rw, self.codes
        keys = self.draw(self.cdf, self.perm, 4 * n_txs).reshape(n_txs, 4)
        hashed = self.rng.random(n_txs) < 0.10
        hkeys = self.draw(self.hcdf, self.hperm, n_txs)
        deletes = self.rng.random((n_txs, 3)) < 0.05
        invalid = self.rng.random(n_txs) < 0.05
        rwsets, incoming = [], []
        for t in range(n_txs):
            k = [self.key(int(i)) for i in keys[t]]
            reads = tuple(rw.KVRead(x, db.get_version("cc", x)) for x in k[:2])
            writes = tuple(
                rw.KVWrite(x, bool(deletes[t, j]), b"" if deletes[t, j] else b"v%d.%d" % (number, t))
                for j, x in enumerate(k[2:])
            )
            colls, rqs, md = (), (), ()
            if hashed[t]:
                kh = self.key_hash(int(hkeys[t]))
                colls = (rw.CollHashedRwSet(
                    "coll0",
                    (rw.KVReadHash(kh, db.get_key_hash_version("cc", "coll0", kh)),),
                    (rw.KVWriteHash(kh, bool(deletes[t, 2]), b"" if deletes[t, 2] else hashlib.sha256(kh).digest()),),
                ),)
            if number == 7 and t == 11:  # a range query: the block takes the host route
                start = int(keys[t, 0])
                rqs = (rw.RangeQueryInfo(
                    self.key(start), self.key(start + 6), True,
                    tuple(rw.KVRead(x, vv.version) for x, vv in
                          db.get_state_range("cc", self.key(start), self.key(start + 6), False)),
                ),)
                invalid[t] = False
            if number == 13 and t == 17:  # a metadata write: the host route
                md = (rw.KVMetadataWrite(k[2], (("owner", b"org1MSP"),)),)
                invalid[t] = False
            rwsets.append(rw.TxRwSet((rw.NsRwSet("cc", reads, writes, rqs, colls, md),)))
            incoming.append(codes.ENDORSEMENT_POLICY_FAILURE if invalid[t] else codes.VALID)
        return rwsets, incoming


def seeded_chain_db(statedb, rw):
    """Two identical VersionedDBs: 1,000,000 committed public keys (names
    zero-padded, so bisect.insort appends) and 50,000 hashed keys of one
    collection."""
    seed = statedb.UpdateBatch()
    for i in range(CHAIN_KEYS):
        seed.put("cc", ChainTraffic.key(i), b"v0", rw.Version(0, i))
    hseed = statedb.HashedUpdateBatch()
    for i in range(CHAIN_HASHED_KEYS):
        kh = ChainTraffic.key_hash(i)
        hseed.put("cc", "coll0", kh, hashlib.sha256(kh).digest(), rw.Version(0, i))
    dbs = []
    for _ in range(2):
        db = statedb.VersionedDB()
        db.apply_updates(seed, hashed=hseed)
        dbs.append(db)
    return dbs


def k5_bytes(R: int, W: int, T: int) -> int:
    """Bytes K5's function must move, each input read once and each output
    written once: the read and write columns (tx and key ids, 8 bytes a
    read and a write), a static-bad flag a read, the mask and the status
    word. The kernel reads the columns once a sweep; its sweeps are a cost
    of the design, which is why it sits above this bound."""
    return 9 * R + 8 * W + T + 4


def k6_bytes(np, cap: int, args, valid) -> int:
    """Bytes K6's function must move for this run's data, each once: the
    columns (init slot and version, 12 bytes an init; slot, claimed
    version, tx and key id, 20 bytes a read; tx, key id, slot and version,
    20 bytes a write), the mask and the status word; each distinct table
    row gathered that no init overwrites (8 bytes in) and each distinct row
    seeded or committed (8 bytes out). `valid` is the launch's mask: a row
    is committed where the last valid writer of its key writes it."""
    init_idx, _iv, r_gid, _rv, _rt, _rk, w_tx, w_key, w_gid, _wv = (
        a.cpu().numpy() for a in args)
    valid = np.asarray(valid, dtype=bool)
    I, R, W, T = len(init_idx), len(r_gid), len(w_tx), len(valid)
    seeded = set(init_idx[(init_idx >= 0) & (init_idx < cap)].tolist())
    gathered = set(np.clip(r_gid, 0, cap - 1).tolist()) - seeded
    live = valid[w_tx] if W else np.zeros(0, dtype=bool)
    last = np.full(int(w_key.max()) + 1 if W else 0, -1)
    np.maximum.at(last, w_key[live], w_tx[live])
    commit = live & (w_tx == last[w_key]) & (w_gid >= 0) & (w_gid < cap)
    written = seeded | set(w_gid[commit].tolist())
    return 12 * I + 20 * R + 20 * W + T + 4 + 8 * len(gathered) + 8 * len(written)


def k6_probe(np, md, table, args, kw) -> dict:
    """K6's shared route's time split at one shape, from thread 0's SM
    clock stamps (`mvcc_device.resolve_resident_stamped`) on a copy of the
    table: the columns' load (thread 0's reads, its writes, the barrier),
    the versions' check, the writers and readers of sweeps 0-4 (later
    sweeps fall in the commit's first interval), the commit; in cycles."""
    _valid, status, stamps = md.resolve_resident_stamped(table.clone(), *args, **kw)
    st = stamps.cpu().numpy().astype(np.int64)
    sweeps = md.converged_sweeps(status.cpu())
    last = "commit_last_writer" if sweeps < 5 else f"sweeps_5_to_{sweeps}_and_commit_last_writer"
    names = ["load_reads", "load_writes", "load_barrier", "check"] + [
        f"sweep{i}_{part}" for i in range(5) for part in ("writers", "readers")] + [
        last, "commit_least", "commit_write"]
    out, prev = {}, st[0]
    for slot, name in zip([16, 17] + list(range(1, 16)), names):
        if st[slot]:
            out[name] = int(st[slot] - prev)
            prev = st[slot]
    return {"cycles": out, "total_cycles": int(st[15] - st[0])}


def k5_probe(np, md, args, kw) -> dict:
    """K5's shared route's time split at one shape, from thread 0's SM clock
    stamps (`mvcc_device.resolve_stamped`): the columns' load (the first
    six columns' loads in flight while the scratch is cleared, up to its
    barrier; their use; the second six; the barrier), the writers and
    readers of sweeps 0-4 (later sweeps fall in the last interval), the
    mask; in cycles."""
    _valid, status, stamps = md.resolve_stamped(*args, **kw)
    st = stamps.cpu().numpy().astype(np.int64)
    sweeps = md.converged_sweeps(status.cpu())
    last = "mask" if sweeps <= 5 else f"sweeps_5_to_{sweeps}_and_mask"
    names = ["load_scratch_barrier", "load_first_half", "load_second_half", "load_barrier"] + [
        f"sweep{i}_{part}" for i in range(5) for part in ("writers", "readers")] + [last]
    out, prev = {}, st[0]
    for slot, name in zip(range(1, 16), names):
        if st[slot]:
            out[name] = int(st[slot] - prev)
            prev = st[slot]
    return {"cycles": out, "total_cycles": int(st[15] - st[0])}


def plain_ms(torch, fn) -> float:
    """Host-clock milliseconds of one call of `fn` (a plain version on the
    card), with the device synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_ms(torch, launch, reps: int, prepare=None) -> float:
    """Mean device time of `launch()` over `reps` launches, from CUDA events
    around each launch. The launches are queued behind a sleep kernel, so
    the events time the device's work and not the host's enqueue.
    `prepare()`, when given, runs on the stream before each launch, outside
    its events (a fresh copy of a table the kernel updates in place)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = []
    for _ in range(reps):
        if prepare is not None:
            prepare()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def mvcc_phases(torch, np, dev):
    """The MVCC phases; returns the K5 and K6 entries of the kernels line."""
    from fabric_tpu_torch.common.txflags import TxValidationCode
    from fabric_tpu_torch.ledger import kvledger, mvcc, statedb
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ledger import rwset as rw
    from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
    from fabric_tpu_torch.ledger.txparse import parse_tx_rwset

    VALID = TxValidationCode.VALID

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    def k5_vs_plain(args, T, K, route):
        valid, status = md.launch_resolve(route, *args, num_txs=T, num_keys=K)
        torch.cuda.synchronize()
        pvalid, pstatus = md.resolve_ref(*args, T, K)
        sweeps = md.converged_sweeps(status.cpu())
        if valid.tolist() != pvalid.tolist() or status.tolist() != pstatus.tolist():
            raise AssertionError(f"{route}: kernel and plain version differ")
        return int((valid.int() - pvalid.int()).abs().max().item()) if T else 0, sweeps

    def k5_routes(args, T, K):
        """Both K5 routes against the plain version at one shape (the
        shared one where the block fits it, and refusing it where not); the
        route its sizes pick."""
        R, W = args[0].numel(), args[3].numel()
        errs, sweeps = [], None
        for route in K5_ROUTES:
            if route == K5_ROUTES[0] and not md.resolve_fits(R, W, T, K):
                try:
                    md.launch_resolve(route, *args, num_txs=T, num_keys=K)
                except RuntimeError:
                    continue
                raise AssertionError("the shared K5 route took a block past its limit")
            err, sweeps = k5_vs_plain(args, T, K, route)
            errs.append(err)
        return max(errs), sweeps, md.resolve_route(R, W, T, K)

    def k6_vs_plain(table, args, T, K, route):
        kt, pt = table.clone(), table.clone()
        valid, status = md.launch_resident(route, kt, *args, num_txs=T, num_keys=K)
        torch.cuda.synchronize()
        pvalid, pstatus = md.resolve_resident_ref(pt, *args, T, K)
        sweeps = md.converged_sweeps(status.cpu())
        if (valid.tolist() != pvalid.tolist() or status.tolist() != pstatus.tolist()
                or not torch.equal(kt, pt)):
            raise AssertionError(f"{route}: kernel and plain version differ")
        err = max(int((valid.int() - pvalid.int()).abs().max().item()) if T else 0,
                  int((kt - pt).abs().max().item()))
        return err, sweeps, valid.cpu().numpy()

    def k6_routes(table, args, T, K):
        """Both K6 routes against the plain version at one shape (the
        shared one only where the block fits it); the route its sizes pick."""
        R, W = args[2].numel(), args[6].numel()
        picked = md.resident_route(R, W, T, K)
        errs, sweeps, valid = [], None, None
        for route in K6_ROUTES:
            if route == "mvcc_resolve_resident" and not md.resident_fits(R, W, T, K):
                continue
            err, sw, v = k6_vs_plain(table, args, T, K, route)
            errs.append(err)
            if route == picked:
                sweeps, valid = sw, v
        return max(errs), sweeps, valid, picked

    # --- kernel vs plain version on the edge-case columns -----------------
    t_phase = time.perf_counter()
    k5, k6 = mvcc_kernel_cases(np)
    r_tx, r_key, r_bad, w_tx, w_key, T, K = k5
    err5, sweeps5, route5 = k5_routes(
        (i32(r_tx), i32(r_key), torch.from_numpy(r_bad).to(dev), i32(w_tx), i32(w_key)), T, K)
    # past K5's shared limit (13,000 reads): the global route by size, and
    # the shared route refuses it
    table, _ii, _iv, r_gid, r_ver, p_tx, p_key, q_tx, q_key, *_rest, Tq, Kq = mvcc_random_case(
        np, np.random.default_rng(MVCC_SEED + 3), 5000, 6_000, PAST_K5_TXS, 5_000, 8_192)
    q_bad = (np.asarray(r_ver) != table[np.clip(r_gid, 0, len(table) - 1)]).any(axis=1)
    errq, sweepsq, routeq = k5_routes(
        (i32(p_tx), i32(p_key), torch.from_numpy(q_bad).to(dev), i32(q_tx), i32(q_key)), Tq, Kq)
    if route5 != K5_ROUTES[0] or routeq != K5_ROUTES[1]:
        raise AssertionError(f"K5 routes {route5}, {routeq}")
    table, *cols, T6, K6 = k6
    err6, sweeps6, _, route6 = k6_routes(i32(table), tuple(i32(c) for c in cols), T6, K6)
    if sweeps5 < 64 or sweeps6 < 64:
        raise AssertionError(f"the 64-tx chain took {sweeps5} / {sweeps6} sweeps")
    # past the shared route's limit (19,400 keys): the global route by size,
    # and the shared route refuses it
    table, *cols, Tp, Kp = mvcc_random_case(np, np.random.default_rng(MVCC_SEED + 2), 300,
                                            19_400, 3_000, 9_000, 20_000)
    cols = tuple(i32(c) for c in cols)
    errp, sweepsp, _, routep = k6_routes(i32(table), cols, Tp, Kp)
    try:
        md.launch_resident(K6_ROUTES[0], i32(table), *cols, num_txs=Tp, num_keys=Kp)
    except RuntimeError:
        pass
    else:
        raise AssertionError("the shared K6 route took a block past its limit")
    if route6 != K6_ROUTES[0] or routep != K6_ROUTES[1]:
        raise AssertionError(f"K6 routes {route6}, {routep}")
    emit({"phase": "mvcc_kernel_vs_plain", "txs": T, "keys": K, "reads": len(r_tx),
          "writes": len(w_tx), "sweeps": [sweeps5, sweeps6], "max_abs_err": [err5, err6],
          "k5_route": route5, "k5_routes_held": list(K5_ROUTES),
          "k5_past_shared_limit": {"txs": Tq, "keys": Kq, "reads": len(p_tx),
                                   "writes": len(q_tx), "route": routeq, "sweeps": sweepsq,
                                   "max_abs_err": errq, "shared_route_refused": True},
          "k6_route": route6, "k6_routes_held": list(K6_ROUTES),
          "past_shared_limit": {"txs": Tp, "keys": Kp, "reads": cols[2].numel(),
                                "writes": cols[6].numel(), "route": routep, "sweeps": sweepsp,
                                "max_abs_err": errp, "shared_route_refused": True},
          "identical": True, "seconds": time.perf_counter() - t_phase})

    captured = {}
    real_resolve, real_resident = md.resolve, md.resolve_resident

    def capture_resolve(*args, **kw):
        captured["k5"] = (args, kw)
        return real_resolve(*args, **kw)

    def capture_resident(versions, *args, **kw):
        captured["k6"] = (versions.clone(), args, kw)
        return real_resident(versions, *args, **kw)

    def config4_block(n_txs):
        """bench.py bench_mvcc's block of n_txs over as many committed keys:
        the state DB, the rwsets through serialize -> parse, the host
        oracle's result (3 timed runs) and its conflicts."""
        db = statedb.VersionedDB()
        seed = statedb.UpdateBatch()
        for i in range(n_txs):
            seed.put("cc", f"k{i}", b"v0", rw.Version(0, i))
        db.apply_updates(seed)
        txs = mvcc_config4_rwsets(rw, n_txs=n_txs)
        t0 = time.perf_counter()
        raw = [serialize_tx_rwset(t) for t in txs]
        t1 = time.perf_counter()
        parsed = [parse_tx_rwset(b) for b in raw]
        t2 = time.perf_counter()
        if parsed != txs:
            raise AssertionError("config #4 rwsets do not survive serialize -> parse")
        incoming = [VALID] * n_txs
        host_ms = []
        for _ in range(3):
            t3 = time.perf_counter()
            want = mvcc.Validator(db).validate_and_prepare_batch(1, parsed, incoming)
            host_ms.append((time.perf_counter() - t3) * 1e3)
        conflicts = sum(c == TxValidationCode.MVCC_READ_CONFLICT for c in want[0])
        if conflicts != n_txs // 10:
            raise AssertionError(f"config #4 at {n_txs} txs: the oracle found {conflicts} conflicts")
        return {"db": db, "seed": seed, "parsed": parsed, "incoming": incoming, "want": want,
                "conflicts": conflicts, "serialize_ms": (t1 - t0) * 1e3,
                "parse_ms": (t2 - t1) * 1e3, "host_oracle_ms": host_ms}

    def device_blocks(blk):
        """Three runs of the block through a DeviceValidator, each held to
        the host oracle's codes and updates: the main path. K5's launches by
        route are counted from 0 over the three runs; returns them with the
        runs' times and splits and the last K5 call's arguments."""
        dv = md.DeviceValidator(blk["db"], device=dev)
        md.resolve = capture_resolve
        for k in md.LAUNCHES:
            md.LAUNCHES[k] = 0
        try:
            splits, block_ms = [], []
            for _ in range(3):
                t3 = time.perf_counter()
                got = dv.validate_and_prepare_batch(1, blk["parsed"], blk["incoming"])
                block_ms.append((time.perf_counter() - t3) * 1e3)
                want = blk["want"]
                if dv.last_path != "device":
                    raise AssertionError("a config #4 block did not take the device route")
                if (got[0] != want[0] or batches_as_values(got[1]) != batches_as_values(want[1])
                        or batches_as_values(got[2]) != batches_as_values(want[2])):
                    raise AssertionError("config #4: device codes or updates differ from the oracle's")
                splits.append(dict(dv.last_ms))
        finally:
            md.resolve = real_resolve
        return {"device_ms": block_ms, "device_split_ms": splits, "sweeps": dv.last_sweeps,
                "route_launches": k5_launches(md), "call": captured["k5"]}

    # --- mvcc_5k: BASELINE config #4 through DeviceValidator, then the same
    # block shape at 13,000 txs, past K5's shared route ----------------------
    t_phase = time.perf_counter()
    c4 = config4_block(MVCC_TXS)
    seed = c4["seed"]
    run4 = device_blocks(c4)
    past = config4_block(PAST_K5_TXS)
    runp = device_blocks(past)
    if (run4["route_launches"] != {K5_ROUTES[0]: 3, K5_ROUTES[1]: 0}
            or runp["route_launches"] != {K5_ROUTES[0]: 0, K5_ROUTES[1]: 3}):
        raise AssertionError(f"K5 launches on the MVCC path: {run4['route_launches']}, "
                             f"{runp['route_launches']}")
    launches5, launches5g = run4["route_launches"][K5_ROUTES[0]], runp["route_launches"][K5_ROUTES[1]]
    args5, kw5 = run4["call"]
    args5p, kw5p = runp["call"]
    err5b, sweeps5b, _ = k5_routes(args5, kw5["num_txs"], kw5["num_keys"])
    err5p, sweeps5p, _ = k5_routes(args5p, kw5p["num_txs"], kw5p["num_keys"])
    # each route's time, in turns at config #4 (global, shared, shared, global)
    shared4 = lambda: real_resolve(*args5, **kw5)  # noqa: E731
    global4 = lambda: md.launch_resolve(K5_ROUTES[1], *args5, **kw5)  # noqa: E731
    turns5 = [device_ms(torch, fn, 20) for fn in (global4, shared4, shared4, global4)]
    ms5, ms5_global = (turns5[1] + turns5[2]) / 2, (turns5[0] + turns5[3]) / 2
    ms5p = device_ms(torch, lambda: real_resolve(*args5p, **kw5p), 20)
    split5 = k5_probe(np, md, args5, kw5)
    plain5 = plain_ms(torch, lambda: md.resolve_ref(*args5, **kw5))
    plain5p = plain_ms(torch, lambda: md.resolve_ref(*args5p, **kw5p))
    R5, W5 = args5[0].numel(), args5[3].numel()
    R5p, W5p = args5p[0].numel(), args5p[3].numel()
    bound5 = k5_bytes(R5, W5, kw5["num_txs"]) / HBM_BYTES_PER_S * 1e3
    bound5p = k5_bytes(R5p, W5p, kw5p["num_txs"]) / HBM_BYTES_PER_S * 1e3
    emit({"phase": "mvcc_5k", "txs": MVCC_TXS, "conflicts": c4["conflicts"], "reads": R5,
          "writes": W5, "keys": kw5["num_keys"], "sweeps": run4["sweeps"],
          "serialize_ms": c4["serialize_ms"], "parse_ms": c4["parse_ms"],
          "host_oracle_ms": c4["host_oracle_ms"], "device_ms": run4["device_ms"],
          "device_split_ms": run4["device_split_ms"], "route_launches": run4["route_launches"],
          "kernel_ms": ms5, "global_route_ms": ms5_global, "kernel_ms_in_turns": turns5,
          "k5_split": split5,
          "past_shared_limit": {
              "txs": PAST_K5_TXS, "conflicts": past["conflicts"], "reads": R5p, "writes": W5p,
              "keys": kw5p["num_keys"], "sweeps": runp["sweeps"],
              "host_oracle_ms": past["host_oracle_ms"], "device_ms": runp["device_ms"],
              "device_split_ms": runp["device_split_ms"],
              "route_launches": runp["route_launches"], "global_route_ms": ms5p,
              "shared_route_refused": True},
          "routes_equal_plain": True, "codes_equal_oracle": True, "updates_equal_oracle": True,
          "seconds": time.perf_counter() - t_phase})

    # --- mvcc_resident_5k: config #4's resident blocks (bench.py:679-725) --
    t_phase = time.perf_counter()
    dev_db, host_db = statedb.VersionedDB(), statedb.VersionedDB()
    dev_db.apply_updates(seed)
    host_db.apply_updates(seed)
    res = md.ResidentDeviceValidator(dev_db, device=dev)
    host = mvcc.Validator(host_db)
    ver = {i: (0, i) for i in range(MVCC_TXS)}
    prev_d = prev_h = b""
    blocks = []
    md.resolve_resident = capture_resident
    for k in md.LAUNCHES:
        md.LAUNCHES[k] = 0
    try:
        for number in range(1, RESIDENT_BLOCKS + 1):
            raw = [serialize_tx_rwset(r) for r in mvcc_config4_rwsets(rw, ver=ver)]
            incoming = [VALID] * MVCC_TXS
            t1 = time.perf_counter()
            d = kvledger.commit_block_state(res, number, raw, incoming, prev_d)
            t2 = time.perf_counter()
            h = kvledger.commit_block_state(host, number, raw, incoming, prev_h)
            t3 = time.perf_counter()
            if (d.flags.tobytes() != h.flags.tobytes() or d.commit_hash != h.commit_hash
                    or batches_as_values(d.updates) != batches_as_values(h.updates)):
                raise AssertionError(f"config #4 resident block {number} differs from the oracle's")
            conflicts = int((d.flags.asarray() == int(TxValidationCode.MVCC_READ_CONFLICT)).sum())
            if conflicts != MVCC_TXS // 10 or res.last_path != "device":
                raise AssertionError(f"config #4 resident block {number}: {conflicts} "
                                     f"conflicts, path {res.last_path}")
            prev_d, prev_h = d.commit_hash, h.commit_hash
            for i in range(MVCC_TXS):  # bench.py: the valid txs' writes committed
                if i % 10 != 5:
                    ver[i] = (number, i)
            blocks.append({"block": number, "commit_ms": (t2 - t1) * 1e3,
                           "host_commit_ms": (t3 - t2) * 1e3, "split_ms": dict(res.last_ms),
                           "sweeps": res.last_sweeps})
    finally:
        md.resolve_resident = real_resident
    routes6 = k6_launches(md)
    launches6 = sum(routes6.values())
    if launches6 != RESIDENT_BLOCKS:
        raise AssertionError(f"config #4 resident: {routes6} K6 launches")
    # K6's kernels entry: the last block, in the steady state; each route
    # timed at its shape (the global route is the design the shared one
    # replaced)
    table6, args6, kw6 = captured["k6"]
    err6b, sweeps6b, valid6, route6b = k6_routes(table6, args6, kw6["num_txs"], kw6["num_keys"])
    scratch = torch.empty_like(table6)
    ms6 = device_ms(torch, lambda: real_resident(scratch, *args6, **kw6), 20,
                    prepare=lambda: scratch.copy_(table6))
    ms6_global = device_ms(torch, lambda: md.launch_resident(K6_ROUTES[1], scratch, *args6, **kw6),
                           20, prepare=lambda: scratch.copy_(table6))
    split6 = k6_probe(np, md, table6, args6, kw6)
    plain6 = plain_ms(torch, lambda: md.resolve_resident_ref(table6.clone(), *args6, **kw6))
    cap6 = table6.shape[0]
    I6, R6, W6 = args6[0].numel(), args6[2].numel(), args6[6].numel()
    bound6 = k6_bytes(np, cap6, args6, valid6) / HBM_BYTES_PER_S * 1e3
    emit({"phase": "mvcc_resident_5k", "blocks": RESIDENT_BLOCKS, "txs_per_block": MVCC_TXS,
          "committed_keys": MVCC_TXS, "capacity": res.capacity, "slots_used": res.slots_used,
          "last_block": {"inits": I6, "reads": R6, "writes": W6, "keys": kw6["num_keys"],
                         "sweeps": sweeps6b, "route": route6b},
          "route_launches": routes6, "kernel_ms": ms6, "global_route_ms": ms6_global,
          "k6_split": split6,
          "commit_hash": prev_d.hex(), "per_block": blocks,
          "codes_updates_hashes_equal_oracle": True, "seconds": time.perf_counter() - t_phase})

    # --- mvcc_resident_chain: 20 blocks, 1M keys, the commit hash chain ----
    t_phase = t0 = time.perf_counter()
    dev_db, host_db = seeded_chain_db(statedb, rw)
    traffic = ChainTraffic(np, rw, TxValidationCode)
    setup_s = time.perf_counter() - t0
    res = md.ResidentDeviceValidator(dev_db, device=dev)
    host = mvcc.Validator(host_db)
    prev_d = prev_h = b""
    blocks = []
    md.resolve_resident = capture_resident
    for k in md.LAUNCHES:
        md.LAUNCHES[k] = 0
    try:
        for number in range(1, CHAIN_BLOCKS + 1):
            if number == 16:  # state changed behind the validator's back
                dev_db.bump_generation()
                host_db.bump_generation()
            rwsets, codes = traffic.block(number, host_db)
            raw = [serialize_tx_rwset(r) for r in rwsets]
            t1 = time.perf_counter()
            d = kvledger.commit_block_state(res, number, raw, codes, prev_d)
            t2 = time.perf_counter()
            h = kvledger.commit_block_state(host, number, raw, codes, prev_h)
            t3 = time.perf_counter()
            if (d.flags.tobytes() != h.flags.tobytes() or d.commit_hash != h.commit_hash
                    or batches_as_values(d.updates) != batches_as_values(h.updates)
                    or batches_as_values(d.hashed) != batches_as_values(h.hashed)):
                raise AssertionError(f"resident chain block {number} differs from the oracle's")
            prev_d, prev_h = d.commit_hash, h.commit_hash
            flags = d.flags.asarray()
            blocks.append({
                "block": number, "path": res.last_path,
                "valid": int((flags == int(VALID)).sum()),
                "mvcc_conflicts": int((flags == int(TxValidationCode.MVCC_READ_CONFLICT)).sum()),
                "phantom_conflicts": int((flags == int(TxValidationCode.PHANTOM_READ_CONFLICT)).sum()),
                "commit_ms": (t2 - t1) * 1e3, "host_commit_ms": (t3 - t2) * 1e3,
                "split_ms": dict(res.last_ms) if res.last_path == "device" else None,
                "sweeps": res.last_sweeps if res.last_path == "device" else None,
            })
    finally:
        md.resolve_resident = real_resident
    chain_routes = k6_launches(md)
    chain_launches = sum(chain_routes.values())
    paths = [b["path"] for b in blocks]
    want_paths = ["host" if n in (7, 13) else "device" for n in range(1, CHAIN_BLOCKS + 1)]
    if paths != want_paths or chain_launches != CHAIN_BLOCKS - 2:
        raise AssertionError(f"resident chain routes {paths}, {chain_launches} launches")
    if res.invalidations != 1:
        raise AssertionError(f"the stale table was dropped {res.invalidations} times, not once")
    tablec, argsc, kwc = captured["k6"]
    errc, sweepsc, _, routec = k6_routes(tablec, argsc, kwc["num_txs"], kwc["num_keys"])
    scratchc = torch.empty_like(tablec)
    msc = device_ms(torch, lambda: real_resident(scratchc, *argsc, **kwc), 10,
                    prepare=lambda: scratchc.copy_(tablec))
    msc_global = device_ms(torch, lambda: md.launch_resident(K6_ROUTES[1], scratchc, *argsc,
                                                              **kwc),
                           10, prepare=lambda: scratchc.copy_(tablec))
    splitc = k6_probe(np, md, tablec, argsc, kwc)
    emit({"phase": "mvcc_resident_chain", "blocks": CHAIN_BLOCKS, "txs_per_block": MVCC_TXS,
          "committed_keys": CHAIN_KEYS, "hashed_keys": CHAIN_HASHED_KEYS,
          "setup_seconds": setup_s, "capacity": res.capacity, "slots_used": res.slots_used,
          "invalidations": res.invalidations, "device_blocks": chain_launches,
          "route_launches": chain_routes,
          "last_block": {"inits": argsc[0].numel(), "reads": argsc[2].numel(),
                         "writes": argsc[6].numel(), "keys": kwc["num_keys"],
                         "sweeps": sweepsc, "max_abs_err": errc, "route": routec},
          "kernel_ms": msc, "global_route_ms": msc_global, "k6_split": splitc,
          "commit_hash": prev_d.hex(),
          "per_block": blocks,
          "codes_updates_hashes_equal_oracle": True, "seconds": time.perf_counter() - t_phase})

    return [
        {"name": "mvcc_resolve", "route": "cuda", "source": "fabric_tpu_torch/csrc/mvcc_resolve.cu",
         "replaces": "fabric_tpu/ledger/mvcc_device.py:85", "launches": launches5,
         "max_abs_err": max(err5, err5b), "ms": ms5, "plain_ms": plain5, "bound_ms": bound5,
         "bound_by": "bytes", "sweeps": sweeps5b, "library_ms": None,
         "global_route_ms": ms5_global, "shape": {"reads": R5, "writes": W5,
                                                  "txs": kw5["num_txs"], "keys": kw5["num_keys"]}},
        {"name": "mvcc_resolve_global", "route": "cuda",
         "source": "fabric_tpu_torch/csrc/mvcc_resolve.cu",
         "replaces": "fabric_tpu/ledger/mvcc_device.py:85", "launches": launches5g,
         "max_abs_err": max(errq, err5p), "ms": ms5p, "plain_ms": plain5p, "bound_ms": bound5p,
         "bound_by": "bytes", "sweeps": sweeps5p, "library_ms": None, "config4_ms": ms5_global,
         "shape": {"reads": R5p, "writes": W5p, "txs": kw5p["num_txs"],
                   "keys": kw5p["num_keys"]}},
        {"name": "mvcc_resolve_resident", "route": "cuda",
         "source": "fabric_tpu_torch/csrc/mvcc_resolve.cu",
         "replaces": "fabric_tpu/ledger/mvcc_device.py:268", "launches": launches6,
         "route_launches": routes6, "k6_route": route6b,
         "max_abs_err": max(err6, err6b, errc, errp), "ms": ms6, "plain_ms": plain6,
         "bound_ms": bound6, "bound_by": "bytes", "sweeps": sweeps6b, "library_ms": None,
         "global_route_ms": ms6_global,
         "chain_last_block": {"route": routec, "ms": msc, "global_route_ms": msc_global,
                              "reads": argsc[2].numel(), "writes": argsc[6].numel(),
                              "keys": kwc["num_keys"]}},
    ]


# ---------------------------------------------------------------------------
# Idemix (K3, K4): BASELINE config #3's batch verification
# ---------------------------------------------------------------------------

IDEMIX_SEED = 1234  # bench.py bench_idemix's random.Random(1234)


def word_diff(torch, a, b) -> int:
    """Largest absolute difference of two integer tensors, word by word
    (int32 words are read as unsigned)."""
    a, b = a.cpu().to(torch.int64), b.cpu().to(torch.int64)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    return int((a & 0xFFFFFFFF).sub(b & 0xFFFFFFFF).abs().max().item()) if a.numel() else 0


def point_err(got, want) -> int:
    """Largest absolute difference of two lists of affine points,
    coordinate by coordinate, the identity read as (0, 0) (not a curve
    point)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} points against {len(want)}")
    return max((abs(a - b) for g, w in zip(got, want) for a, b in zip(g or (0, 0), w or (0, 0))),
               default=0)


def msm_edge_lanes(host, rng):
    """K = 8 lanes with the edge cases of the MSM: identity bases, zero
    scalars, e = 1, e = r - 1, r * G = O, equal bases (doubling inside the
    complete addition), and random bases and scalars."""
    def rand_point():
        return host.g1_mul(host.G1_GEN, rng.randrange(1, host.R))

    g, r = host.G1_GEN, host.R
    p, q = rand_point(), rand_point()
    lanes = [
        ([None] * 8, [rng.randrange(r) for _ in range(8)]),  # identity bases
        ([rand_point() for _ in range(8)], [0] * 8),  # zero scalars
        ([g] + [None] * 7, [1] + [0] * 7),  # e = 1
        ([g] + [None] * 7, [r - 1] + [0] * 7),  # e = r - 1
        ([g, g] + [None] * 6, [r - 1, 1] + [0] * 6),  # r * G = O
        ([p, p, p, p] + [None] * 4, [5, 5, 2 ** 200 + 7, 3] + [0] * 4),  # equal bases
        ([p, q, p, q, g, None, p, q], [rng.randrange(r) for _ in range(8)]),
    ]
    lanes += [([rand_point() for _ in range(8)], [rng.randrange(r) for _ in range(8)])
              for _ in range(5)]
    return lanes


def msm_wide_lanes(host, rng, k_count):
    """Four of msm_edge_lanes (r * G = O, equal bases, mixed, random)
    widened to K bases: a lane's bases repeated, with new random scalars
    past the eighth."""
    lanes = msm_edge_lanes(host, rng)[4:8]
    while len(lanes[0][0]) < k_count:
        more = k_count - len(lanes[0][0])
        lanes = [(b + b[:more], e + [rng.randrange(host.R) for _ in b[:more]]) for b, e in lanes]
    return lanes


def idemix_kernel_vs_plain(torch, np, dev):
    """K3 and K4 against their plain versions on the card at small sizes:
    K3's points lane by lane (the kernel sums in another order, so its
    projective words differ), every output word of K4; returns each
    kernel's largest difference."""
    import random

    from fabric_tpu_torch.common import fp256bn as host
    from fabric_tpu_torch.ops import bn256_kernel as bk
    from fabric_tpu_torch.ops import pairing_kernel as pkn

    t_phase = time.perf_counter()
    rng = random.Random(IDEMIX_SEED + 1)
    lanes = msm_edge_lanes(host, rng)
    bases, scalars = bk.pack_batch([b for b, _ in lanes], [e for _, e in lanes])
    bases, scalars = torch.from_numpy(bases).to(dev), torch.from_numpy(scalars).to(dev)
    got = bk.unpack_points(bk.msm_batch(bases, scalars))
    torch.cuda.synchronize()
    plain = bk.unpack_points(bk.msm_batch_ref(bases, scalars))
    torch.cuda.synchronize()
    err3 = point_err(got, plain)
    want = []
    for bs, es in lanes:
        acc = None
        for b, e in zip(bs, es):
            acc = host.g1_add(acc, host.g1_mul(b, e))
        want.append(acc)
    if err3 or got != want or plain != want:
        raise AssertionError(f"bn256_msm: kernel, plain version and oracle differ ({err3})")
    # K = 33: a warp a lane whose first thread takes a second base
    wide = msm_wide_lanes(host, rng, 33)
    bases, scalars = bk.pack_batch([b for b, _ in wide], [e for _, e in wide])
    got = bk.unpack_points(bk.msm_batch(torch.from_numpy(bases).to(dev),
                                        torch.from_numpy(scalars).to(dev)))
    want = []
    for bs, es in wide:
        acc = None
        for b, e in zip(bs, es):
            acc = host.g1_add(acc, host.g1_mul(b, e))
        want.append(acc)
    if got != want:
        raise AssertionError("bn256_msm: K = 33 lanes differ from the oracle")

    gamma = rng.randrange(1, host.R)
    w = host.g2_mul(host.G2_GEN, gamma)
    tables = pkn.Ate2Kernel(w, device=dev).tables
    a = [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R)) for _ in range(6)]
    pairs = [
        (a[0], host.g1_mul(a[0], gamma)),  # true
        (a[1], host.g1_mul(a[1], (gamma + 1) % host.R)),  # false
        None,
        (a[2], None),  # ABar = identity
        (a[3], host.g1_mul(a[3], gamma)),
        (a[4], host.g1_add(host.g1_mul(a[4], gamma), host.G1_GEN)),
        (a[5], host.g1_mul(a[5], gamma)),
        (host.G1_GEN, host.g1_mul(host.G1_GEN, gamma)),
    ]
    want4 = [True, False, False, False, True, False, True, True]
    cols = pkn.lane_columns(pairs, dev)
    words = pkn.miller2_words(tables, *cols[:4])
    torch.cuda.synchronize()
    plain_words = pkn.miller2_values_ref_words(tables, *cols[:4])
    err4 = word_diff(torch, words, plain_words)
    mask = pkn.unity_check(tables, *cols)
    torch.cuda.synchronize()
    plain_mask = pkn.unity_check_ref(tables, *cols)
    if err4 or mask.tolist() != plain_mask.tolist():
        raise AssertionError(f"ate2_unity: kernel and plain version differ ({err4})")
    if mask.tolist() != want4:
        raise AssertionError(f"ate2_unity: mask {mask.tolist()}, expected {want4}")
    f1, f2, fe = pkn.words_to_host(words)[0]  # the true pair
    if (f1 != host.miller_loop(w, pairs[0][0]) or f2 != host.miller_loop(host.G2_GEN, pairs[0][1])
            or not host.gt_is_unity(fe)):
        raise AssertionError("ate2_debug: lane 0 differs from the host oracle's")
    emit({"phase": "idemix_kernel_vs_plain", "msm_lanes": len(lanes), "msm_k": 8,
          "msm_k33_equal_oracle": True,
          "pairing_lanes": len(pairs), "max_abs_err": {"bn256_msm": err3, "ate2_unity": err4},
          "mask": mask.tolist(), "identical": True, "seconds": time.perf_counter() - t_phase})
    return {"bn256_msm": err3, "ate2_unity": err4}


IDEMIX_ATTRS = ["OU", "Role", "EnrollmentID", "RevocationHandle"]
IDEMIX_VALUES = [11, 22, 33, 44]
IDEMIX_RH_INDEX = 3
IDEMIX_MSG = b"idemix bench message"
IDEMIX_SIZES = (64, 256)  # bench.py's ladder sizes from which it accepts (bench.py:555-563)
IDEMIX_UNIQUE = 8
IDEMIX_ORACLE_SIGS = 4  # bench.py's n_host


def idemix_world(random):
    """bench.py bench_idemix (bench.py:439-606) with the port's issuance:
    random.Random(1234), four attributes with values 11, 22, 33, 44, the
    revocation handle at 3, an unsigned ALG_NO_REVOCATION CRI, every
    attribute hidden, and 8 unique signatures of one message."""
    from fabric_tpu_torch import idemix
    from fabric_tpu_torch.common import fp256bn as host

    rng = random.Random(IDEMIX_SEED)
    ik = idemix.new_issuer_key(IDEMIX_ATTRS, rng)
    ipk = ik["ipk"]
    sk = host.rand_mod_order(rng)
    nonce = host.big_to_bytes(host.rand_mod_order(rng))
    req = idemix.new_cred_request(sk, nonce, ipk, rng)
    cred = idemix.new_credential(ik, req, IDEMIX_VALUES, rng)
    cri = {"revocation_alg": idemix.ALG_NO_REVOCATION}

    def sign(disclosure, msg):
        nym, r_nym = idemix.make_nym(sk, ipk, rng)
        return idemix.new_signature(cred, sk, nym, r_nym, ipk, disclosure, msg,
                                    IDEMIX_RH_INDEX, cri, rng)

    uniq = [sign([0, 0, 0, 0], IDEMIX_MSG) for _ in range(IDEMIX_UNIQUE)]
    return ipk, uniq, sign


def idemix_phases(torch, np, dev, imad_rate, keep=None):
    """The Idemix phases; returns the K3 and K4 entries of the kernels line.
    A `keep` dict receives the arguments of config #3's largest batch and of
    the mixed batch ("idemix_sets") for factory_phase."""
    import copy
    import random

    from fabric_tpu_torch import idemix
    from fabric_tpu_torch.common import fp256bn as host
    from fabric_tpu_torch.idemix import batch as ib
    from fabric_tpu_torch.idemix import scheme
    from fabric_tpu_torch.ops import bn256_kernel as bk
    from fabric_tpu_torch.ops import pairing_kernel as pkn

    errs = idemix_kernel_vs_plain(torch, np, dev)

    # --- idemix_config3: BASELINE config #3 through verify_signatures_batch --
    t_phase = time.perf_counter()
    ipk, uniq, sign = idemix_world(random)
    setup_s = time.perf_counter() - t_phase
    hidden = [0, 0, 0, 0]

    def batch_args(count):
        return ([uniq[i % len(uniq)] for i in range(count)], [hidden] * count, ipk,
                [IDEMIX_MSG] * count, [[None] * 4] * count, IDEMIX_RH_INDEX)

    ib.verify_signatures_batch(*batch_args(1), backend="scheme")  # warm-up
    t0 = time.perf_counter()
    oracle_sample = ib.verify_signatures_batch(*batch_args(IDEMIX_ORACLE_SIGS), backend="scheme")
    oracle_ms_per_sig = (time.perf_counter() - t0) * 1e3 / IDEMIX_ORACLE_SIGS
    oracle_uniq = ib.verify_signatures_batch(*batch_args(IDEMIX_UNIQUE), backend="scheme")
    if not all(oracle_sample) or not all(oracle_uniq):
        raise AssertionError("config #3: the scheme oracle rejects a signature")

    captured = {}
    real_unity, real_msm = pkn.unity_check, bk.msm_batch

    def capture_unity(*args):
        captured["k4"] = args
        return real_unity(*args)

    def capture_msm(*args):
        captured["k3"] = args
        return real_msm(*args)

    sizes = {}
    pkn.unity_check, bk.msm_batch = capture_unity, capture_msm
    ib.verify_signatures_batch(*batch_args(IDEMIX_SIZES[0]), device=dev)  # warm-up
    for k in pkn.LAUNCHES:
        pkn.LAUNCHES[k] = 0
    bk.LAUNCHES["bn256_msm"] = 0
    try:
        for size in IDEMIX_SIZES:
            ms, splits = [], []
            for _ in range(3):
                split = {}
                t0 = time.perf_counter()
                mask = ib.verify_signatures_batch(*batch_args(size), device=dev, split_ms=split)
                ms.append((time.perf_counter() - t0) * 1e3)
                splits.append(split)
                if not all(mask) or mask[:IDEMIX_UNIQUE] != oracle_uniq[:size]:
                    raise AssertionError(f"config #3 at {size}: mask differs from the oracle's")
            sizes[size] = {"ms_per_sig": [m / size for m in ms], "split_ms": splits,
                           "k4": captured["k4"], "k3": captured["k3"]}
    finally:
        pkn.unity_check, bk.msm_batch = real_unity, real_msm
    launches = {"ate2_unity": pkn.LAUNCHES["ate2_unity"], "bn256_msm": bk.LAUNCHES["bn256_msm"]}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the config #3 path")

    # each kernel's time at the path's shapes (CUDA events), its plain
    # version's on the same inputs, its bound
    for size, sh in sizes.items():
        k4, k3 = sh["k4"], sh["k3"]
        sh["k4_ms"] = device_ms(torch, lambda: real_unity(*k4), 3)
        sh["k3_ms"] = device_ms(torch, lambda: real_msm(*k3), 3)
    big = sizes[IDEMIX_SIZES[-1]]
    k4, k3 = big["k4"], big["k3"]
    got4, got3 = real_unity(*k4), bk.unpack_points(real_msm(*k3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain4 = pkn.unity_check_ref(*k4)
    torch.cuda.synchronize()
    plain4_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain3 = bk.msm_batch_ref(*k3)
    torch.cuda.synchronize()
    plain3_ms = (time.perf_counter() - t0) * 1e3
    err4 = max(errs["ate2_unity"], word_diff(torch, got4, plain4))
    err3 = max(errs["bn256_msm"], point_err(got3, bk.unpack_points(plain3)))
    if err4 or err3:
        raise AssertionError(f"config #3 shapes: kernels and plain versions differ ({err4}, {err3})")

    def bound(muls, nbytes):
        ops_s, bytes_s = muls * bk.IMAD_PER_MONT_MUL / imad_rate, nbytes / HBM_BYTES_PER_S
        return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"

    # each bound from this run's lanes: bound_ms for the least work known
    # (pairing_kernel.LEAST, bn256_kernel.muls_least), bound_ms_kernel for
    # the algorithm the kernel runs, bound_ms_replaced for the replaced
    # program's
    tables4, cols4 = k4[0], k4[1:]
    lanes4 = cols4[0].shape[1]
    live4 = int(cols4[4].sum().item())
    bytes4 = (sum(c.numel() * c.element_size() for c in cols4) + lanes4
              + 2 * tables4.words(dev).numel() * 4 + pkn.STEPS * 4)
    bound4, by4 = bound(live4 * pkn.MULS_LEAST, bytes4)
    bound4_kernel = bound(live4 * pkn.MULS_PER_LANE, bytes4)[0]
    bound4_replaced = bound(live4 * pkn.MULS_PER_LANE_REPLACED, bytes4)[0]
    k_count, lanes3 = k3[0].shape[0], k3[0].shape[-1]
    bytes3 = sum(t.numel() * t.element_size() for t in k3) + 3 * 20 * 8 * lanes3
    # count the work of each lane's real bases only: t1 and t3 pad 3 bases
    # to K with identity bases (Z = 0) and zero scalars
    real3 = ((k3[0][:, 2] != 0).any(dim=1) & (k3[1] != 0).any(dim=1)).sum(dim=0).tolist()
    k_real = {str(k): real3.count(k) for k in sorted(set(real3))}
    # the least work known is the replaced program's algorithm at the real
    # bases, so bound_ms_replaced is bound_ms
    bound3, by3 = bound(sum(bk.muls_least(k) for k in real3), bytes3)
    bound3_kernel = bound(sum(bk.muls_per_lane(k, k_count) for k in real3), bytes3)[0]
    # the host's steps around K3 at this shape, from every timed run
    msm_split = {key: [sp[key] for sp in big["split_ms"]]
                 for key in ("msm_pack", "msm_kernel", "msm_unpack")}
    emit({"phase": "idemix_config3", "setup_seconds": setup_s, "unique_signatures": IDEMIX_UNIQUE,
          "oracle_ms_per_sig": oracle_ms_per_sig, "oracle_sigs": IDEMIX_ORACLE_SIGS,
          "sizes": {str(s): {"ms_per_sig": sh["ms_per_sig"], "split_ms": sh["split_ms"],
                             "pairing_lanes": sh["k4"][1].shape[1],
                             "msm_lanes": sh["k3"][0].shape[-1], "msm_k": sh["k3"][0].shape[0],
                             "k4_kernel_ms": sh["k4_ms"], "k3_kernel_ms": sh["k3_ms"]}
                    for s, sh in sizes.items()},
          "launches": launches, "masks_all_true_and_equal_oracle": True,
          "msm_pack_ms": msm_split["msm_pack"], "msm_kernel_ms": msm_split["msm_kernel"],
          "msm_unpack_ms": msm_split["msm_unpack"],
          "seconds": time.perf_counter() - t_phase})

    # --- idemix_mask: a mixed batch held lane by lane to the oracle ------
    t_phase = time.perf_counter()
    disclosed = [0, 1, 0, 0]
    sig_disclosed = sign(disclosed, b"m1")

    def changed(sig, **fields):
        out = copy.deepcopy(sig)
        out.update(fields)
        return out

    abar0 = host.g1_mul(scheme.ecp_from_proto(uniq[3]["a_bar"]), 2)
    s_sk = (host.big_from_bytes(uniq[2]["proof_s_sk"]) + 1) % host.R
    lanes = [
        ("valid", uniq[0], hidden, IDEMIX_MSG, [None] * 4),
        ("valid-disclosed", sig_disclosed, disclosed, b"m1", [None, 22, None, None]),
        ("wrong-message", uniq[1], hidden, b"WRONG", [None] * 4),
        ("proof-s-sk+1", changed(uniq[2], proof_s_sk=host.big_to_bytes(s_sk)), hidden,
         IDEMIX_MSG, [None] * 4),
        ("wrong-disclosed-value", sig_disclosed, disclosed, b"m1", [None, 999, None, None]),
        ("abar-doubled", changed(uniq[3], a_bar=scheme.ecp_to_proto(abar0)), hidden, IDEMIX_MSG,
         [None] * 4),
        ("abar-identity", changed(uniq[4], a_bar=scheme.ecp_to_proto(None)), hidden, IDEMIX_MSG,
         [None] * 4),
        ("aprime-identity", changed(uniq[5], a_prime=scheme.ecp_to_proto(None)), hidden, IDEMIX_MSG,
         [None] * 4),
        ("wrong-s-value-count", changed(uniq[6], proof_s_attrs=uniq[6]["proof_s_attrs"][:-1]),
         hidden, IDEMIX_MSG, [None] * 4),
        ("valid-2", uniq[7], hidden, IDEMIX_MSG, [None] * 4),
    ]
    cols = [list(c) for c in zip(*lanes)]
    args = (cols[1], cols[2], ipk, cols[3], cols[4], IDEMIX_RH_INDEX)
    got = ib.verify_signatures_batch(*args, device=dev)
    want = ib.verify_signatures_batch(*args, backend="scheme")
    expected = [True, True] + [False] * 7 + [True]
    if got != want or want != expected:
        raise AssertionError(f"idemix_mask: device {got}, oracle {want}, expected {expected}")
    if keep is not None:
        keep["idemix_sets"] = {f"config3_{IDEMIX_SIZES[-1]}": batch_args(IDEMIX_SIZES[-1]),
                               f"mixed_{len(lanes)}": args}
    emit({"phase": "idemix_mask", "lanes": cols[0], "mask": got, "mask_equal_oracle": True,
          "seconds": time.perf_counter() - t_phase})

    # --- idemix_wide: 13 attributes, t2's MSM lane of 17 bases, a warp -----
    t_phase = time.perf_counter()
    rng = random.Random(IDEMIX_SEED)
    names = [f"attr{i}" for i in range(13)]
    ik13 = idemix.new_issuer_key(names, rng)
    sk13 = host.rand_mod_order(rng)
    req13 = idemix.new_cred_request(sk13, host.big_to_bytes(host.rand_mod_order(rng)),
                                    ik13["ipk"], rng)
    cred13 = idemix.new_credential(ik13, req13, [11 * (i + 1) for i in range(13)], rng)
    sigs13 = []
    for msg in (b"m", b"m", b"m2"):
        nym, r_nym = idemix.make_nym(sk13, ik13["ipk"], rng)
        sigs13.append(idemix.new_signature(cred13, sk13, nym, r_nym, ik13["ipk"], [0] * 13, msg,
                                           IDEMIX_RH_INDEX, {"revocation_alg": 0}, rng))
    msgs13 = [b"m", b"m", b"m"]  # the third was signed on another message
    args13 = (sigs13, [[0] * 13] * 3, ik13["ipk"], msgs13, [[None] * 13] * 3, IDEMIX_RH_INDEX)
    before = bk.LAUNCHES["bn256_msm"]
    got = ib.verify_signatures_batch(*args13, device=dev)
    want = ib.verify_signatures_batch(*args13, backend="scheme")
    if got != want or want != [True, True, False] or bk.LAUNCHES["bn256_msm"] != before + 1:
        raise AssertionError(f"idemix_wide: device {got}, oracle {want}")
    emit({"phase": "idemix_wide", "attributes": 13, "t2_bases": 17, "mask": got,
          "mask_equal_oracle": True, "k3_launches": 1, "seconds": time.perf_counter() - t_phase})

    source = "fabric_tpu_torch/csrc/bn256.cu"
    return [
        {"name": "bn256_msm", "route": "cuda", "source": source,
         "replaces": "fabric_tpu/ops/bn256_kernel.py:201", "launches": launches["bn256_msm"],
         "max_abs_err": err3, "ms": big["k3_ms"], "plain_ms": plain3_ms, "bound_ms": bound3,
         "bound_by": by3, "bound_ms_kernel": bound3_kernel, "bound_ms_replaced": bound3,
         "threads_per_lane": bk.threads_per_lane(k_count), "lanes": lanes3, "k": k_count,
         "k_real": k_real, "library_ms": None},
        {"name": "ate2_unity", "route": "cuda", "source": source,
         "replaces": "fabric_tpu/ops/pairing_kernel.py:233", "launches": launches["ate2_unity"],
         "max_abs_err": err4, "ms": big["k4_ms"], "plain_ms": plain4_ms, "bound_ms": bound4,
         "bound_by": by4, "bound_ms_kernel": bound4_kernel, "bound_ms_replaced": bound4_replaced,
         "threads_per_lane": pkn.THREADS_PER_LANE, "lanes": lanes4, "live_lanes": live4,
         "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# Block validation of BASELINE config #2 (K2 through the validator) and K7
# ---------------------------------------------------------------------------

CONFIG2_SEED = 2026
CONFIG2_TXS = 1000  # bench.py bench_block_1k
CONFIG2_RUNS = 5  # timed runs after one warm-up, each on a fresh validator
CONFIG2_CHANNEL = "benchchan"
CONFIG2_POLICY = "OutOf(2,'Org1MSP.member','Org2MSP.member','Org3MSP.member')"
# validator_mask: the kind of tx i is MASK_KINDS[i % 10]; each dup_txid tx
# repeats the valid envelope 6 places before it
MASK_KINDS = ("valid", "bad_creator_sig", "bad_endorsement", "unknown_msp", "unknown_cc",
              "bad_txid", "dup_txid", "nil", "bad_payload", "revoked_endorser")
MASK_TXS = 70
# the codes the JAX validator gives each kind (tests/test_torch_validator.py
# holds the JAX validator to them on this construction)
MASK_CODES = {"valid": 0, "bad_creator_sig": 4, "bad_endorsement": 10, "unknown_msp": 4,
              "unknown_cc": 25, "bad_txid": 8, "dup_txid": 9, "nil": 1, "bad_payload": 2,
              "revoked_endorser": 10}


class Config2Net:
    """BASELINE config #2's network as bench.py's `_Net` builds it
    (bench.py:314-388), minted by the port's cryptogen from a seed: Org1-3,
    Org1's user as client, Org1's and Org2's peers endorsing, OutOf(2, ...)
    on benchcc; plus a peer of Org2 that Org2's CRL revokes and a user of an
    org no MSP manager knows, for validator_mask."""

    def __init__(self, seed=CONFIG2_SEED):
        import random

        from fabric_tpu_torch.msp.cryptogen import generate_org
        from fabric_tpu_torch.msp.identity import MSP, MSPManager
        from fabric_tpu_torch.msp.signer import SigningIdentity
        from fabric_tpu_torch.policy.ast import from_dsl

        rng = random.Random(seed)
        self.rng = rng
        self.orgs = [generate_org(f"org{i}.bench", f"Org{i}MSP", rng=rng) for i in (1, 2, 3)]
        revoked = self.orgs[1].ca.enroll("peer9.org2.bench", ou="peer")
        self.orgs[1].ca.revoke(revoked)
        self.revoked = SigningIdentity(revoked, rng)
        self.stranger = SigningIdentity(generate_org("org9.bench", "Org9MSP", rng=rng).users[0], rng)
        self.client = SigningIdentity(self.orgs[0].users[0], rng)
        self.endorsers = [SigningIdentity(o.peers[0], rng) for o in self.orgs[:2]]
        self.policy = from_dsl(CONFIG2_POLICY)
        # one MSP manager for every validator, as bench.py shares its
        # `mgr`: an identity's chain is validated once, then memoized
        self.managers = {crl: MSPManager([MSP(c) for c in self.msp_configs(crl)])
                         for crl in (False, True)}

    def msp_configs(self, with_crl=False):
        return [o.msp_config(with_crl=with_crl) for o in self.orgs]

    def validator(self, provider, with_crl=False, channel=CONFIG2_CHANNEL):
        from fabric_tpu_torch.validation.validator import (
            BlockValidator, ChaincodeDefinition, ChaincodeRegistry)

        registry = ChaincodeRegistry([ChaincodeDefinition("benchcc", self.policy)])
        return BlockValidator(channel, self.managers[with_crl], provider, registry)

    def envelope(self, i, cc="benchcc", client=None, endorsers=None, channel=CONFIG2_CHANNEL,
                 reads=(), results=None):
        """bench.py make_block's tx i: one write of k{i} in benchcc, after
        `reads` ((key, Version) pairs) when given; `results` replaces the
        whole TxReadWriteSet."""
        from fabric_tpu_torch.endorser import txbuilder as tb
        from fabric_tpu_torch.ledger import rwset as rw
        from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset

        client = client or self.client
        if results is None:
            results = serialize_tx_rwset(rw.TxRwSet((rw.NsRwSet(
                "benchcc", tuple(rw.KVRead(k, v) for k, v in reads),
                (rw.KVWrite(f"k{i}", False, b"v"),)),)))
        bundle = tb.create_proposal(client, channel, cc, [b"invoke", b"%d" % i])
        responses = [tb.endorse_proposal(bundle, e, results) for e in endorsers or self.endorsers]
        return tb.create_signed_tx(bundle, client, responses)

    @staticmethod
    def make_block(datas, number, previous_hash=b"\x33" * 32):
        """A sealed block of `datas`. The phases that do not chain keep the
        fixed previous hash, so their blocks stay byte for byte what they
        were; only `chain` links headers."""
        from fabric_tpu_torch.protos import protoutil

        block = protoutil.new_block(number, previous_hash)
        block["data"]["data"] = list(datas)
        return protoutil.seal_block(block)

    @staticmethod
    def flipped(number, n_txs, channel=CONFIG2_CHANNEL, invalid=0):
        """{tx: kind} of the `invalid` txs of block `number` of `chain` that
        carry a flipped signature, "bad_endorsement" and "bad_creator_sig"
        in turn: txs i with i % 10 == 3, drawn from the channel and the
        number, so two blocks that share a launch flip different lanes and
        no tx that the conflict pattern reads or writes is touched."""
        import random

        slots = random.Random(f"flipped {channel} {number}").sample(
            range(n_txs // 10), min(invalid, n_txs // 10))
        return {10 * j + 3: ("bad_endorsement", "bad_creator_sig")[k % 2]
                for k, j in enumerate(slots)}

    def chain_datas(self, number, n_txs, conflict=False, channel=CONFIG2_CHANNEL, invalid=0):
        """The envelopes of block `number` of `chain`, as wire bytes: tx i
        writes k{i}; with `conflict` every tx i with i % 10 == 9 also reads
        k{i-1} at the version block number - 1 committed, which tx i-1 of
        the same block writes first (config #4's pattern: n_txs // 10
        MVCC_READ_CONFLICTs); the txs of `flipped` carry one flipped
        signature each. The signers' random stream is reseeded from the
        channel and the number first, so a block's bytes do not depend on
        what was signed before it (and blocks can be signed in other
        processes)."""
        from fabric_tpu_torch.ledger.rwset import Version
        from fabric_tpu_torch.protos import fabric, wire

        self.rng.seed(f"chain {channel} {number}")
        flipped = self.flipped(number, n_txs, channel, invalid)
        datas = []
        for i in range(n_txs):
            reads = ((f"k{i - 1}", Version(number - 1, i - 1)),) if conflict and i % 10 == 9 else ()
            env = self.envelope(i, channel=channel, reads=reads)
            if flipped.get(i) == "bad_endorsement":
                env = self.resigned(env, self.flip_endorsement)
            elif flipped.get(i) == "bad_creator_sig":
                env = self.flip_creator_sig(env)
            datas.append(wire.encode(fabric.ENVELOPE, env))
        return datas

    def chain_codes(self, number, n_txs, conflict=False, channel=CONFIG2_CHANNEL, invalid=0):
        """The TRANSACTIONS_FILTER block `number` of `chain` must get."""
        codes = [MASK_CODES["valid"]] * n_txs
        if conflict:
            for i in range(9, n_txs, 10):
                codes[i] = 11  # MVCC_READ_CONFLICT
        for i, kind in self.flipped(number, n_txs, channel, invalid).items():
            codes[i] = MASK_CODES[kind]
        return bytes(codes)

    def link(self, block_datas, first=0, previous_hash=b""):
        """Blocks first, first + 1, ... of `block_datas` as wire bytes,
        linked: the first carries `previous_hash` (block 0's is empty) and
        each later block the header hash of the one before it."""
        from fabric_tpu_torch.protos import fabric, protoutil, wire

        out, prev = [], previous_hash
        for number, datas in enumerate(block_datas, start=first):
            block = self.make_block(datas, number, prev)
            prev = protoutil.block_header_hash(block["header"])
            out.append(wire.encode(fabric.BLOCK, block))
        return out

    def chain(self, n_blocks, n_txs, conflict_block=None, channel=CONFIG2_CHANNEL, invalid=0):
        """A linked chain of config #2 blocks as wire bytes (`chain_datas`,
        `link`); fresh txids every block."""
        return self.link([self.chain_datas(number, n_txs, number == conflict_block, channel,
                                           invalid) for number in range(n_blocks)])

    def block(self, n_txs, number=1, channel=CONFIG2_CHANNEL):
        from fabric_tpu_torch.protos import fabric, wire

        # every call draws fresh nonces, so fresh txids over the same keys
        return self.make_block([wire.encode(fabric.ENVELOPE, self.envelope(i, channel=channel))
                                for i in range(n_txs)], number)

    def resigned(self, env, change):
        """`env` with its payload passed through `change` and signed anew
        by the client."""
        from fabric_tpu_torch.protos import fabric, wire

        payload = wire.decode(fabric.PAYLOAD, env["payload"])
        change(payload)
        raw = wire.encode(fabric.PAYLOAD, payload)
        return {"payload": raw, "signature": self.client.sign(raw)}

    @staticmethod
    def flip_endorsement(payload):
        """Flip the last byte of the second endorsement's signature."""
        from fabric_tpu_torch.protos import fabric, wire

        tx = wire.decode(fabric.TRANSACTION, payload["data"])
        cap = wire.decode(fabric.CHAINCODE_ACTION_PAYLOAD, tx["actions"][0]["payload"])
        sig = bytearray(cap["action"]["endorsements"][1]["signature"])
        sig[-1] ^= 0xFF
        cap["action"]["endorsements"][1]["signature"] = bytes(sig)
        tx["actions"][0]["payload"] = wire.encode(fabric.CHAINCODE_ACTION_PAYLOAD, cap)
        payload["data"] = wire.encode(fabric.TRANSACTION, tx)

    @staticmethod
    def flip_creator_sig(env):
        """`env` with the last bit of the creator's signature flipped."""
        return {**env, "signature": env["signature"][:-1] + bytes([env["signature"][-1] ^ 0x01])}

    def mask_block(self):
        """validator_mask's block and the codes expected lane by lane."""
        datas, want = self.mask_datas()
        return self.make_block(datas, 2), want

    def mask_datas(self, n_txs=MASK_TXS):
        """`n_txs` envelopes of the invalid kinds of MASK_KINDS in turn, and
        the codes expected lane by lane."""
        from fabric_tpu_torch.protos import fabric, wire

        def bad_txid(payload):
            chdr = wire.decode(fabric.CHANNEL_HEADER, payload["header"]["channel_header"])
            chdr["tx_id"] = "deadbeef" * 8
            payload["header"]["channel_header"] = wire.encode(fabric.CHANNEL_HEADER, chdr)

        datas, want = [], []
        for i in range(n_txs):
            kind = MASK_KINDS[i % len(MASK_KINDS)]
            env = None
            if kind == "valid":
                env = self.envelope(i)
            elif kind == "bad_creator_sig":
                env = self.flip_creator_sig(self.envelope(i))
            elif kind == "bad_endorsement":
                env = self.resigned(self.envelope(i), self.flip_endorsement)
            elif kind == "unknown_msp":
                env = self.envelope(i, client=self.stranger)
            elif kind == "unknown_cc":
                env = self.envelope(i, cc="ghostcc")
            elif kind == "bad_txid":
                env = self.resigned(self.envelope(i), bad_txid)
            elif kind == "bad_payload":
                env = {"payload": b"\x0a\x05abc", "signature": self.client.sign(b"\x0a\x05abc")}
            elif kind == "revoked_endorser":
                env = self.envelope(i, endorsers=[self.endorsers[0], self.revoked])
            if kind == "dup_txid":
                datas.append(datas[i - 6])
            else:
                datas.append(b"" if kind == "nil" else wire.encode(fabric.ENVELOPE, env))
            want.append(MASK_CODES[kind])
        return datas, want


def oracle_provider(memo=None):
    """The port's P-256 oracle behind the provider SPI: the reference the
    validator's device route is held to. With `memo` ({(point, signature,
    digest): bool}) it reads a lane's verdict from there, and keeps there
    each one it computes."""
    from fabric_tpu_torch.common import p256
    from fabric_tpu_torch.crypto.bccsp import Provider, parse_and_precheck

    class OracleProvider(Provider):
        def verify(self, key, signature, digest):
            k = (key.point, signature, digest)
            if memo is not None and k in memo:
                return memo[k]
            r, s = parse_and_precheck(signature)
            ok = p256.verify_digest(key.point, digest, r, s)
            if memo is not None:
                memo[k] = ok
            return ok

    return OracleProvider()


def policy_cases():
    """(rule, num_principals, sat) cases for K7: tests/test_policy.py's five
    policies on every 2 x 2 sat matrix (:105-123) and its 25 random policies
    (random.Random(1234), :125-136); edge lanes at S in {31, 32, 33, 64, 65,
    100} (n = 0, n above the child count, NOutOf with no children, a failing
    branch whose children claimed signers, a leaf root, depth 23); B = 1."""
    import itertools
    import random

    import numpy as np

    from fabric_tpu_torch.policy.ast import NOutOf, SignedBy, from_dsl

    cases = []
    for text in ("AND('A.member','B.member')", "OR('A.member','B.member')",
                 "AND('A.member','A.member')",
                 "OutOf(1, AND('A.member','B.member'), 'B.member')",
                 "OutOf(2, 'A.member', 'B.member', 'A.member')"):
        env = from_dsl(text)
        P = len(env.identities)
        sat = np.stack([np.array(bits, dtype=bool).reshape(2, P)
                        for bits in itertools.product([0, 1], repeat=2 * P)])
        cases.append((env.rule, P, sat))

    def random_policy(rng, num_p, depth=0):
        if depth >= 2 or rng.random() < 0.4:
            return SignedBy(rng.randrange(num_p))
        k = rng.randint(1, 3)
        return NOutOf(rng.randint(1, k), [random_policy(rng, num_p, depth + 1) for _ in range(k)])

    rng = random.Random(1234)
    for trial in range(25):
        num_p, num_s = rng.randint(1, 4), rng.randint(1, 4)
        rule = random_policy(rng, num_p)
        cases.append((rule, num_p, np.random.default_rng(trial).random((16, num_s, num_p)) < 0.45))

    deep = SignedBy(0)
    for _ in range(22):
        deep = NOutOf(1, [NOutOf(3, [SignedBy(1), SignedBy(0), SignedBy(2)]), deep])
    edges = [
        NOutOf(0, [SignedBy(0), SignedBy(1)]),
        NOutOf(3, [SignedBy(0), SignedBy(1)]),
        NOutOf(0, []),
        NOutOf(1, []),
        NOutOf(1, [NOutOf(3, [SignedBy(0), SignedBy(1), SignedBy(2)]),
                   NOutOf(2, [SignedBy(0), SignedBy(0)])]),
        SignedBy(2),
        deep,
    ]
    srng = np.random.default_rng(7)
    for S in (31, 32, 33, 64, 65, 100):
        for rule in edges:
            for B, density in ((1, 0.05), (300, 0.02), (300, 0.5)):
                cases.append((rule, 3, srng.random((B, S, 3)) < density))
    return cases


def policy_bound_ms(B: int, S: int, P: int, nodes: int) -> float:
    """K7's least time: each bool read once, each verdict written once, the
    program read once (16 bytes a node), over the memory rate."""
    return (B * S * P + B + 16 * nodes) / HBM_BYTES_PER_S * 1e3


K7_ROUTES = ("policy_eval", "policy_eval_global")
# a batch as wide as its widest transaction: 33 signatures take K7 past its
# shared route's one signer word
WIDE_SIGNERS = 33


def policy_kernel_vs_plain(torch, np, dev) -> int:
    """K7 against its plain version on the card and against evaluate_host,
    every lane of every case: through `policy_eval` on the route the case's
    shape picks, and on each route that takes the shape (the global
    route takes every one); returns the largest difference."""
    from fabric_tpu_torch.ops import policy_kernel as pk
    from fabric_tpu_torch.policy.ast import SignaturePolicyEnvelope
    from fabric_tpu_torch.policy.evaluator import evaluate_host

    t_phase = time.perf_counter()
    cases = policy_cases()
    lanes = differing = 0
    err = 0
    widest = (0, 0)
    by_route = {r: {"cases": 0, "lanes": 0} for r in K7_ROUTES}
    for rule, P, sat_np in cases:
        program = pk.encode_program(rule, P, dev)
        sat = torch.from_numpy(np.ascontiguousarray(sat_np)).to(dev)
        S, nodes = sat_np.shape[1], program.nodes.shape[0]
        picked = pk.policy_route(S, P, program.depth, nodes)
        runs = [pk.policy_eval(sat, program)]
        for route in K7_ROUTES:
            if route == K7_ROUTES[0] and not pk.shared_fits(S, P, program.depth, nodes):
                try:
                    pk.launch_route(route, sat, program)
                except RuntimeError:
                    continue
                raise AssertionError("K7's shared route took a shape past its limits")
            runs.append(pk.launch_route(route, sat, program))
            by_route[route]["cases"] += 1
            by_route[route]["lanes"] += len(sat_np)
        torch.cuda.synchronize()
        plain = pk.policy_eval_ref(sat, program).cpu()
        env = SignaturePolicyEnvelope(rule, [None] * P)
        host = torch.tensor([evaluate_host(env, m) for m in sat_np], dtype=torch.bool)
        for got in runs:
            g = got.cpu()
            err = max(err, int((g.to(torch.int32) - plain.to(torch.int32)).abs().max().item()))
            differing += int((g != plain).sum().item()) + int((g != host).sum().item())
        lanes += len(sat_np)
        if picked == K7_ROUTES[0]:
            widest = max(widest, (pk.shared_bytes(S, P, program.depth, nodes), program.depth))
    # B = 0 returns an empty verdict and launches nothing, on either route
    before = dict(pk.LAUNCHES)
    empty_sat = torch.zeros((0, 2, 2), dtype=torch.bool, device=dev)
    empty_prog = pk.encode_program(cases[0][0], 2, dev)
    empties = [pk.policy_eval(empty_sat, empty_prog)] + [
        pk.launch_route(r, empty_sat, empty_prog) for r in K7_ROUTES]
    if any(e.shape != (0,) for e in empties) or pk.LAUNCHES != before:
        raise AssertionError("K7 launched on an empty batch")
    if differing or err:
        raise AssertionError(f"K7: {differing} lanes differ from the plain version or the oracle")
    emit({"phase": "policy_kernel_vs_plain", "cases": len(cases), "lanes": lanes,
          "by_route": by_route, "differing_lanes": differing, "max_abs_err": err,
          "shared_route_widest_bytes": widest[0], "deepest": widest[1],
          "empty_batch_launched": False, "seconds": time.perf_counter() - t_phase})
    return err


def validator_phases(torch, np, dev, k2_block=None, n_txs=CONFIG2_TXS, runs=CONFIG2_RUNS):
    """validator_config2, validator_mask and validator_commit; returns K7's
    two entries of the kernels line (a route each), and config #2's block and
    the mask block (their envelopes) for the native phase. `k2_block`, K2's
    and the table kernel's times at the block's shape, goes on config #2's
    line beside its verify wait."""
    from fabric_tpu_torch.common.txflags import TxValidationCode
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.ledger import kvledger, mvcc, statedb
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.ops import policy_kernel as pk
    from fabric_tpu_torch.policy.evaluator import compile_batched
    from fabric_tpu_torch.protos import fabric, wire
    from fabric_tpu_torch.validation.blockparse import parse_block

    err7 = policy_kernel_vs_plain(torch, np, dev)

    # --- validator_config2: bench.py bench_block_1k on the card ------------
    t_phase = time.perf_counter()
    net = Config2Net()
    block = net.block(n_txs, number=1)
    raw_block = wire.encode(fabric.BLOCK, block)
    setup_s = time.perf_counter() - t_phase
    for table in (p256k.LAUNCHES, pk.LAUNCHES, md.LAUNCHES):
        for k in table:
            table[k] = 0
    per_run, validator = [], None
    for run in range(runs + 1):  # run 0 is the warm-up
        b = wire.decode(fabric.BLOCK, raw_block)
        validator = net.validator(CUDAProvider(device=dev))
        before = p256k.LAUNCHES["p256_verify_bytes"]
        t0 = time.perf_counter()
        flags = validator.validate(b)
        ms = (time.perf_counter() - t0) * 1e3
        if flags.tobytes() != bytes(n_txs):
            raise AssertionError("config #2 expected an all-VALID block")
        if validator.last_sig_backend != "cuda" or validator.last_parser != "native":
            raise AssertionError(f"validator ran on {validator.last_sig_backend}, parsed by "
                                 f"{validator.last_parser}")
        if p256k.LAUNCHES["p256_verify_bytes"] - before != 1:
            raise AssertionError("config #2: K2 must launch once a block")
        if run:
            per_run.append({"ms": ms, "split_ms": dict(validator.last_ms)})
    # K7 on the block: every tx's satisfaction rows, no pattern memo
    parsed = parse_block(wire.decode(fabric.BLOCK, raw_block)["data"]["data"])
    # the last validator's signature verdicts belong to its own parse
    validator = net.validator(CUDAProvider(device=dev))
    validator.validate(wire.decode(fabric.BLOCK, raw_block), parsed=parsed)
    rows = [validator.signer_sat_rows(tx, net.policy) for tx in parsed]
    S = max(r.shape[0] for r in rows)
    P = len(net.policy.identities)
    sat_np = np.zeros((len(rows), S, P), dtype=bool)
    for i, r in enumerate(rows):
        sat_np[i, : r.shape[0]] = r
    sat = torch.from_numpy(sat_np).to(dev)
    verdicts = compile_batched(net.policy, S, device=dev)(sat)
    # the same rows in a batch 33 signers wide, as compile_batched takes a
    # batch whose widest transaction carries 33 signatures: the global route
    wide_np = np.zeros((len(rows), WIDE_SIGNERS, P), dtype=bool)
    wide_np[:, :S] = sat_np
    wide = torch.from_numpy(wide_np).to(dev)
    verdicts_wide = compile_batched(net.policy, WIDE_SIGNERS, device=dev)(wide)
    launches = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                "policy_eval": pk.LAUNCHES["policy_eval"],
                "policy_eval_global": pk.LAUNCHES["policy_eval_global"]}
    if (launches["p256_verify_bytes"] != runs + 2 or launches["policy_eval"] != 1
            or launches["policy_eval_global"] != 1):
        raise AssertionError(f"config #2 path launches: {launches}")
    program = pk.encode_program(net.policy.rule, P, dev)
    plain = pk.policy_eval_ref(sat, program)
    plain_wide = pk.policy_eval_ref(wide, program)
    want = torch.tensor([f == 0 for f in flags.tobytes()], dtype=torch.bool)
    for got, ref in ((verdicts, plain), (verdicts_wide, plain_wide)):
        if not (torch.equal(got.cpu(), ref.cpu()) and torch.equal(got.cpu(), want)):
            raise AssertionError("K7's verdicts on config #2 differ from the plain version or the flags")
    global2 = pk.launch_route(K7_ROUTES[1], sat, program)
    torch.cuda.synchronize()
    if not torch.equal(global2.cpu(), want):
        raise AssertionError("K7's global route differs from the flags on config #2")
    err7 = max(err7, *(int((g.cpu().to(torch.int32) - r.cpu().to(torch.int32)).abs().max())
                       for g, r in ((verdicts, plain), (verdicts_wide, plain_wide),
                                    (global2, plain))))
    # each route's time, in turns at config #2's shape (global, shared,
    # shared, global); the global route alone at the wide batch
    shared2 = lambda: pk.policy_eval(sat, program)  # noqa: E731
    global2_fn = lambda: pk.launch_route(K7_ROUTES[1], sat, program)  # noqa: E731
    turns7 = [device_ms(torch, fn, 50) for fn in (global2_fn, shared2, shared2, global2_fn)]
    ms7, ms7_global = (turns7[1] + turns7[2]) / 2, (turns7[0] + turns7[3]) / 2
    ms7w = device_ms(torch, lambda: pk.policy_eval(wide, program), 50)
    plain7 = plain_ms(torch, lambda: pk.policy_eval_ref(sat, program))
    plain7w = plain_ms(torch, lambda: pk.policy_eval_ref(wide, program))
    nodes = program.nodes.shape[0]
    bound7 = policy_bound_ms(len(rows), S, P, nodes)
    bound7w = policy_bound_ms(len(rows), WIDE_SIGNERS, P, nodes)
    best = min(r["ms"] for r in per_run)
    emit({"phase": "validator_config2", "txs": n_txs, "signature_lanes": 3 * n_txs, "keys": 3,
          "setup_seconds": setup_s, "runs": per_run, "ms_per_block_best": best,
          "ms_per_block_range": [best, max(r["ms"] for r in per_run)],
          "all_valid": True, "backend": "cuda", "parser": "native", "k2_launches_per_block": 1,
          "verify_wait_ms": [r["split_ms"].get("verify_wait") for r in per_run],
          "k2_at_block_ms": k2_block,
          "k7": {"lanes": len(rows), "signers": S, "principals": P, "nodes": nodes, "ms": ms7,
                 "global_route_ms": ms7_global, "ms_in_turns": turns7, "bound_ms": bound7,
                 "plain_ms": plain7, "launches": launches["policy_eval"],
                 "wide": {"signers": WIDE_SIGNERS, "route": K7_ROUTES[1], "ms": ms7w,
                          "bound_ms": bound7w, "plain_ms": plain7w,
                          "launches": launches["policy_eval_global"]},
                 "verdicts_equal_flags": True},
          "seconds": time.perf_counter() - t_phase})

    # --- validator_mask: the invalid kinds, lane by lane --------------------
    t_phase = time.perf_counter()
    mask_block, want_codes = net.mask_block()
    raw_mask = wire.encode(fabric.BLOCK, mask_block)
    mask_validator = net.validator(CUDAProvider(device=dev), with_crl=True)
    got = mask_validator.validate(wire.decode(fabric.BLOCK, raw_mask))
    if mask_validator.last_sig_backend != "cuda" or mask_validator.last_parser != "native":
        raise AssertionError("validator_mask: not the native parse and the card")
    oracle = net.validator(oracle_provider(), with_crl=True).validate(
        wire.decode(fabric.BLOCK, raw_mask))
    if list(got.tobytes()) != want_codes or oracle.tobytes() != got.tobytes():
        raise AssertionError(f"validator_mask: device {list(got.tobytes())}, oracle "
                             f"{list(oracle.tobytes())}, expected {want_codes}")
    emit({"phase": "validator_mask", "txs": len(want_codes), "kinds": list(MASK_KINDS),
          "codes": {k: MASK_CODES[k] for k in MASK_KINDS}, "flags_equal_expected": True,
          "flags_equal_oracle_provider": True, "seconds": time.perf_counter() - t_phase})

    # --- validator_commit: three blocks through commit_block_state (K6) -----
    t_phase = time.perf_counter()
    dev_db, host_db = statedb.VersionedDB(), statedb.VersionedDB()
    resident = md.ResidentDeviceValidator(dev_db, device=dev)
    host = mvcc.Validator(host_db)
    for table in (p256k.LAUNCHES, md.LAUNCHES):
        for k in table:
            table[k] = 0
    prev_d = prev_h = b""
    per_block = []
    for number in (1, 2, 3):
        b = wire.decode(fabric.BLOCK, raw_block) if number == 1 else net.block(n_txs, number)
        parsed = parse_block(b["data"]["data"])
        t0 = time.perf_counter()
        commit_validator = net.validator(CUDAProvider(device=dev))
        flags = commit_validator.validate(b, parsed=parsed)
        t1 = time.perf_counter()
        if commit_validator.last_sig_backend != "cuda" or commit_validator.last_parser != "native":
            raise AssertionError("validator_commit: not the native parse and the card")
        codes = [TxValidationCode(c) for c in flags.tobytes()]
        results = [tx.results for tx in parsed]
        d = kvledger.commit_block_state(resident, number, results, codes, prev_d)
        t2 = time.perf_counter()
        h = kvledger.commit_block_state(host, number, results, codes, prev_h)
        if d.commit_hash != h.commit_hash or d.flags.tobytes() != h.flags.tobytes():
            raise AssertionError(f"validator_commit: block {number} differs from the host route")
        if d.flags.tobytes() != bytes(n_txs) or resident.last_path != "device":
            raise AssertionError(f"validator_commit: block {number} path {resident.last_path}")
        prev_d, prev_h = d.commit_hash, h.commit_hash
        per_block.append({"block": number, "validate_ms": (t1 - t0) * 1e3,
                          "commit_ms": (t2 - t1) * 1e3, "commit_hash": d.commit_hash.hex()})
    if sum(k6_launches(md).values()) != 3 or p256k.LAUNCHES["p256_verify_bytes"] != 3:
        raise AssertionError(f"validator_commit launches: {dict(md.LAUNCHES)}")
    emit({"phase": "validator_commit", "blocks": 3, "txs_per_block": n_txs,
          "per_block": per_block, "k6_launches": 3, "k2_launches": 3,
          "commit_hashes_equal_host_route": True, "seconds": time.perf_counter() - t_phase})

    source, replaces = "fabric_tpu_torch/csrc/policy_eval.cu", "fabric_tpu/policy/evaluator.py:68"
    blocks = {"config2": wire.decode(fabric.BLOCK, raw_block)["data"]["data"],
              "mask": wire.decode(fabric.BLOCK, raw_mask)["data"]["data"]}
    return blocks, [
        {"name": "policy_eval", "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches["policy_eval"], "max_abs_err": err7, "ms": ms7,
         "plain_ms": plain7, "bound_ms": bound7, "bound_by": "bytes", "lanes": len(rows),
         "signers": S, "principals": P, "library_ms": None, "global_route_ms": ms7_global},
        {"name": "policy_eval_global", "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches["policy_eval_global"], "max_abs_err": err7, "ms": ms7w,
         "plain_ms": plain7w, "bound_ms": bound7w, "bound_by": "bytes", "lanes": len(rows),
         "signers": WIDE_SIGNERS, "principals": P, "library_ms": None, "config2_ms": ms7_global},
    ]


# ---------------------------------------------------------------------------
# The native host runtime, and BASELINE config #5 (multi-channel commit)
# ---------------------------------------------------------------------------

CONFIG5_CHANNELS = 4  # bench.py bench_multichannel: 4 channels x 2,000-tx blocks
CONFIG5_TXS = 2000
CONFIG5_RUNS = 5  # timed runs after one warm-up, on one validator a channel as bench.py keeps


def parsed_view(tx, hashed: bool):
    """What the validator and the commit read of a parsed tx; a job's
    digest is hashed here from its signed bytes where the parse kept those
    (`hashed`: the Python parse)."""

    def job(j):
        if j is None:
            return None
        return j.identity_bytes, j.signature, (hashlib.sha256(j.data).digest() if hashed
                                               else j.digest)

    return (int(tx.code), tx.header_type, tx.channel_id, tx.tx_id, tx.creator, tx.namespace,
            tx.config_data, job(tx.creator_sig_job), [job(j) for j in tx.endorsement_jobs],
            tx.ns_entries, tx.has_md_writes, tx.results, tx.rwset)


def native_phase(np, build_s: float, der_sets: dict, blocks: dict) -> None:
    """The native phase: the g++ build's seconds, which SHA-256 the library
    runs, the native DER parse against its plain version (`crypto/sigparse.
    batch_der_parse_python`) on each set of `der_sets`, and the native block
    parse against the per-transaction Python parse on each block of
    `blocks`, field by field, each route timed once on the host clock."""
    from fabric_tpu_torch.crypto.sigparse import batch_der_parse, batch_der_parse_python
    from fabric_tpu_torch.utils import native
    from fabric_tpu_torch.validation.blockparse import parse_block, parse_block_python

    t_phase = time.perf_counter()
    out = {"phase": "native", "build_seconds": build_s, "library": native.library_path().name,
           "sha256_backend": native.sha256_backend()}
    for label, sigs in der_sets.items():
        t0 = time.perf_counter()
        got = batch_der_parse(sigs)
        t1 = time.perf_counter()
        want = batch_der_parse_python(sigs)
        t2 = time.perf_counter()
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"native DER parse differs from the plain version on {label}")
        out[f"der_{label}"] = {"signatures": len(sigs), "accepted": int((got[2] & got[3]).sum()),
                               "native_ms": (t1 - t0) * 1e3, "python_ms": (t2 - t1) * 1e3,
                               "equal_python": True}
    for label, datas in blocks.items():
        t0 = time.perf_counter()
        got = parse_block(datas)
        t1 = time.perf_counter()
        want = parse_block_python(datas)
        t2 = time.perf_counter()
        if (not got.native or list(got.iter_written_keys()) != list(want.iter_written_keys())
                or [parsed_view(g, False) for g in got] != [parsed_view(w, True) for w in want]):
            raise AssertionError(f"native block parse differs from the Python parse on {label}")
        out[f"parse_{label}"] = {"txs": len(datas), "native_ms": (t1 - t0) * 1e3,
                                 "python_ms": (t2 - t1) * 1e3, "equal_python": True}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def multichannel_phase(torch, np, dev, imad_rate, n_channels=CONFIG5_CHANNELS,
                       n_txs=CONFIG5_TXS, runs=CONFIG5_RUNS, keep=None) -> dict:
    """multichannel_config5: bench.py's config #5 (bench_multichannel,
    bench.py:736-808) on the card, one block of `n_txs` txs per channel
    through MultiChannelValidator, a warm-up and `runs` timed runs on one
    validator a channel: every channel's flags all VALID and equal to that
    channel's own validate, the native parse for every block, K1 once a
    run. Returns K1's time, launches, plain version and bound at the stacked
    shape, for its entry of the kernels line. A `keep` dict receives the
    blocks, each channel's flags alone and the network ("config5")."""
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.ops import p256_kernel as pk
    from fabric_tpu_torch.parallel.multichannel import MultiChannelValidator
    from fabric_tpu_torch.protos import fabric, wire
    from fabric_tpu_torch.utils import native

    t_phase = time.perf_counter()
    net = Config2Net()
    channels = [f"bench{i}" for i in range(n_channels)]
    raw = {ch: wire.encode(fabric.BLOCK, net.block(n_txs, channel=ch)) for ch in channels}
    setup_s = time.perf_counter() - t_phase
    # each channel alone, through its own validate over CUDAProvider (K2)
    alone = {}
    for ch in channels:
        v = net.validator(CUDAProvider(device=dev), channel=ch)
        alone[ch] = v.validate(wire.decode(fabric.BLOCK, raw[ch])).tobytes()
        if alone[ch] != bytes(n_txs) or v.last_sig_backend != "cuda" or v.last_parser != "native":
            raise AssertionError(f"config #5: channel {ch} alone is not all VALID on the card")

    multi = MultiChannelValidator(
        {ch: net.validator(CUDAProvider(device=dev), channel=ch) for ch in channels}, device=dev)
    real, captured = pk.verify_batch, []

    def capture(*args):
        captured[:] = args
        return real(*args)

    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    per_run = []
    pk.verify_batch = capture
    try:
        for run in range(runs + 1):  # run 0 is the warm-up
            blocks = {ch: wire.decode(fabric.BLOCK, raw[ch]) for ch in channels}
            before, parses = pk.LAUNCHES["p256_verify_limbs"], native.CALLS["fn_block_parse"]
            full_gcs = gc.get_stats()[2]["collections"]
            t0 = time.perf_counter()
            flags = multi.validate(blocks)
            ms = (time.perf_counter() - t0) * 1e3
            full_gcs = gc.get_stats()[2]["collections"] - full_gcs
            if pk.LAUNCHES["p256_verify_limbs"] - before != 1:
                raise AssertionError("config #5: K1 must launch once a validate")
            if native.CALLS["fn_block_parse"] - parses != n_channels:
                raise AssertionError("config #5: a block did not take the native parse")
            for ch in channels:
                v = multi.validators[ch]
                if (flags[ch].tobytes() != alone[ch] or v.last_parser != "native"
                        or v.last_sig_backend != "cuda"):
                    raise AssertionError(f"config #5: channel {ch} differs from its own validate")
            if run:
                per_run.append({"ms": ms, "tx_per_s": n_channels * n_txs / ms * 1e3,
                                "device_ms": multi.last_device_ms, "full_gcs": full_gcs,
                                "split_ms": dict(multi.last_split_ms)})
    finally:
        pk.verify_batch = real
    launches = dict(pk.LAUNCHES)
    if launches != {**launches, "p256_verify_limbs": runs + 1, "p256_verify_bytes": 0,
                    "p256_key_tables": 0}:
        raise AssertionError(f"config #5 path launches: {launches}")

    # K1 alone at the stacked shape: its time, its plain version, its bound
    args = list(captured)
    lanes, live = args[0].shape[1], int(args[-1].sum().item())
    ms1 = device_ms(torch, lambda: real(*args), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pk.verify_batch_ref(*args)
    torch.cuda.synchronize()
    plain1 = (time.perf_counter() - t0) * 1e3
    got = real(*args)
    err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max().item())
    if err:
        raise AssertionError("config #5: K1 differs from its plain version at the stacked shape")
    nbytes = sum(a.numel() * a.element_size() for a in args) + lanes + pk.g_comb_words().nbytes
    k1 = {"lanes": lanes, "live_lanes": live, "channels": n_channels, "ms": ms1,
          "plain_ms": plain1, "max_abs_err": err, "launches": launches["p256_verify_limbs"],
          **p256_bounds(pk.work_limb_route(live), nbytes, imad_rate)}
    best = min(r["ms"] for r in per_run)
    emit({"phase": "multichannel_config5", "channels": n_channels, "txs_per_channel": n_txs,
          "signature_lanes": 3 * n_channels * n_txs, "setup_seconds": setup_s, "runs": per_run,
          "ms_range": [best, max(r["ms"] for r in per_run)],
          "aggregate_tx_per_s_range": [min(r["tx_per_s"] for r in per_run),
                                       max(r["tx_per_s"] for r in per_run)],
          "all_valid": True, "flags_equal_each_channel_alone": True, "parser": "native",
          "backend": "cuda", "k1_launches_per_validate": 1, "k1": k1,
          "seconds": time.perf_counter() - t_phase})
    if keep is not None:
        keep["config5"] = {"raw": raw, "alone": alone, "net": net}
    return k1


# ---------------------------------------------------------------------------
# The peer's commit path: CommitPipeline, Channel, the shared VerifyBatcher
# and the persistent KVLedger on config #2 chains and config #5 channels
# ---------------------------------------------------------------------------

PIPELINE_BLOCKS = 10  # config #2 blocks in the pipelined chain
PIPELINE_CONFLICT_BLOCK = 5  # its block with config #4's read conflicts
PIPELINE_DEPTH = 2
PIPELINE_CONFIG5_BLOCKS = 2  # config #5 blocks a channel in the four-channel run
PIPELINE_FLIPPED = 4  # txs a block with a flipped signature (endorsement, creator)
ORACLE_SAMPLE = 8  # verified lanes a K2 launch the oracle checks beside its refused ones

_POOL_NET = None


def _pool_init(blob: bytes) -> None:
    global _POOL_NET
    import pickle

    _POOL_NET = pickle.loads(blob)


def _pool_chain_datas(args):
    return _POOL_NET.chain_datas(*args)


def build_chains(net, jobs: dict) -> dict:
    """{label: (n_blocks, n_txs, conflict_block, channel, invalid)} ->
    {label: [raw block, ...]}: every block's envelopes signed in a pool of spawned
    processes (the signing is pure Python), each seeded by its channel and
    number, then linked in order here. The pool's processes are joined
    before this returns."""
    import multiprocessing
    import os
    import pickle
    from concurrent.futures import ProcessPoolExecutor

    tasks = [(label, (number, n_txs, number == conflict, channel, invalid))
             for label, (n_blocks, n_txs, conflict, channel, invalid) in jobs.items()
             for number in range(n_blocks)]
    with ProcessPoolExecutor(min(len(tasks), len(os.sched_getaffinity(0))),
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_pool_init, initargs=(pickle.dumps(net),)) as pool:
        datas = list(pool.map(_pool_chain_datas, [args for _, args in tasks]))
    out = {label: [] for label in jobs}
    for (label, _), d in zip(tasks, datas):
        out[label].append(d)
    return {label: net.link(ds) for label, ds in out.items()}


def ledger_rows(path, tables=("state", "hashed", "pvt", "history", "meta",
                               "confighistory")) -> dict:
    """Every row of a ledger's SQLite tables (all of them unless `tables`
    names some), sorted."""
    import sqlite3

    db = sqlite3.connect(str(path))
    try:
        return {t: sorted(db.execute(f"SELECT * FROM {t}").fetchall()) for t in tables}
    finally:
        db.close()


def stored_blocks(path) -> list:
    """Every block of a closed ledger's block file (a `.chain`), in order."""
    from fabric_tpu_torch.ledger.blockstore import BlockStore

    store = BlockStore(str(path))
    try:
        return list(store.iter_blocks())
    finally:
        store.close()


def recording_cuda_provider(dev):
    """A CUDAProvider that keeps each launch's lanes, its device inputs and
    the verdicts its resolver returned, so the lanes K2 verified on a
    pipelined run can be held against the plain version and the oracle.
    Behind a BatchingProvider its launches come from the batcher's one
    dispatcher thread."""
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider

    class RecordingCUDAProvider(CUDAProvider):
        def __init__(self, device):
            super().__init__(device=device)
            self.records = []
            self._inputs = None

        def device_inputs(self, prep, limbs, size):
            fn, args = super().device_inputs(prep, limbs, size)
            self._inputs = (prep is not None, args)
            return fn, args

        def batch_verify_async(self, keys, signatures, digests):
            resolve = super().batch_verify_async(keys, signatures, digests)
            rec = {"keys": list(keys), "sigs": list(signatures), "digests": list(digests),
                   "bytes_route": self._inputs[0], "args": self._inputs[1], "verdicts": None}
            self.records.append(rec)

            def resolved():
                rec["verdicts"] = resolve()
                return rec["verdicts"]

            return resolved

    return RecordingCUDAProvider(dev)


def lane_records(recorder) -> list:
    """A recording provider's launches without their device inputs: each
    launch's keys, signatures, digests and K2's verdicts."""
    return [{k: r[k] for k in ("keys", "sigs", "digests", "verdicts")} for r in recorder.records]


def hold_k2_lanes(torch, pk, records, oracle, rng, flipped: int, sample: int, label: str,
                  plain_above: int = 0, always=None) -> dict:
    """K2's lanes on a pipelined run, as the recording provider kept them:
    every launch took the bytes route and resolved; the lanes it refused
    are exactly the run's `flipped` signatures; its largest launch equals,
    lane by lane at its padded shape, the plain version on the same device
    inputs if it is wider than `plain_above` padded lanes (a phase whose
    launches are no wider than one another phase holds skips the plain
    version's 17-21 s); and the oracle agrees on every refused lane, on
    every lane whose key `always(key)` names, and on `sample` other verified
    lanes a launch. Raises on any difference; returns what was held."""
    lanes = [len(r["keys"]) for r in records]
    if not records or any(r["verdicts"] is None or len(r["verdicts"]) != n or not r["bytes_route"]
                          for r, n in zip(records, lanes)):
        raise AssertionError(f"{label}: a K2 launch did not resolve on the bytes route")
    refused = sum(r["verdicts"].count(False) for r in records)
    if refused != flipped:
        raise AssertionError(f"{label}: K2 refused {refused} lanes, {flipped} were flipped")
    big = max(records, key=lambda r: len(r["keys"]))
    plain_s = None
    plain = int(big["args"][0].shape[0]) > plain_above
    if plain:
        t0 = time.perf_counter()
        want = pk.verify_batch_bytes_ref(*big["args"])
        if want.is_cuda:
            torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if want[: len(big["keys"])].tolist() != big["verdicts"] or want[len(big["keys"]):].any():
            raise AssertionError(f"{label}: K2's largest launch differs from its plain version")
    held, oracle_s = 0, 0.0
    for r in records:
        v = r["verdicts"]
        named = {i for i, k in enumerate(r["keys"]) if always is not None and always(k)}
        idx = [i for i, ok in enumerate(v) if not ok or i in named]
        verified = [i for i, ok in enumerate(v) if ok and i not in named]
        idx += rng.sample(verified, min(sample, len(verified)))
        t0 = time.perf_counter()
        want = oracle.batch_verify([r["keys"][i] for i in idx], [r["sigs"][i] for i in idx],
                                   [r["digests"][i] for i in idx])
        oracle_s += time.perf_counter() - t0
        if list(want) != [v[i] for i in idx]:
            raise AssertionError(f"{label}: K2 and the oracle disagree on a lane")
        held += len(idx)
    return {"launch_lanes": lanes, "refused": refused,
            "plain_lanes": len(big["keys"]) if plain else None,
            "plain_padded_lanes": int(big["args"][0].shape[0]) if plain else None,
            "plain_seconds": plain_s,
            "oracle_lanes": held, "oracle_ms_per_signature": oracle_s / held * 1e3}


def pipeline_phases(torch, np, dev, n_blocks=PIPELINE_BLOCKS, n_txs=CONFIG2_TXS,
                    conflict_block=PIPELINE_CONFLICT_BLOCK, n_channels=CONFIG5_CHANNELS,
                    config5_txs=CONFIG5_TXS, config5_blocks=PIPELINE_CONFIG5_BLOCKS,
                    flipped=PIPELINE_FLIPPED, oracle_sample=ORACLE_SAMPLE, keep=None) -> dict:
    """pipeline_config2 and pipeline_config5: the peer's commit path on the
    card. Returns the launches of K2, the key-comb kernel and K5 on the
    pipelined config #2 chain, for the kernels line; a `keep` dict receives
    the network and the signed config #2 chain ("net", "raws") for
    snapshot_phase, each chain's K2 launches as recorded (their lanes and
    verdicts, "k2_records") for factory_phase, and the pipelined chain's
    filters, commit hashes and ms a block ("pipeline_config2") for
    serve_phase."""
    import random
    import shutil
    import threading
    from pathlib import Path

    from fabric_tpu_torch.common import fabobs
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ledger.kvledger import KVLedger
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.parallel.batcher import BatchingProvider
    from fabric_tpu_torch.peer.channel import Channel
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.protos import fabric, wire
    from fabric_tpu_torch.validation.validator import ChaincodeDefinition, ChaincodeRegistry

    t_phase = time.perf_counter()
    net = Config2Net()
    registry = ChaincodeRegistry([ChaincodeDefinition("benchcc", net.policy)])
    channels5 = [f"bench{i}" for i in range(n_channels)]
    jobs = {CONFIG2_CHANNEL: (n_blocks, n_txs, conflict_block, CONFIG2_CHANNEL, flipped)}
    jobs.update({ch: (config5_blocks, config5_txs, None, ch, flipped) for ch in channels5})
    chains = build_chains(net, jobs)
    raws = chains[CONFIG2_CHANNEL]
    if keep is not None:
        keep.update(net=net, raws=raws)
    want_codes = [net.chain_codes(number, n_txs, number == conflict_block, CONFIG2_CHANNEL,
                                  flipped) for number in range(n_blocks)]
    want5 = {ch: [net.chain_codes(number, config5_txs, False, ch, flipped)
                  for number in range(config5_blocks)] for ch in channels5}
    n_flipped = sum(len(net.flipped(number, n_txs, CONFIG2_CHANNEL, flipped))
                    for number in range(n_blocks))
    n_flipped5 = sum(len(net.flipped(number, config5_txs, ch, flipped))
                     for ch in channels5 for number in range(config5_blocks))
    setup_s = time.perf_counter() - t_phase
    oracle, rng = oracle_provider(), random.Random(CONFIG2_SEED)
    root = Path(__file__).resolve().parent / "build" / "smoke_ledgers"
    shutil.rmtree(root, ignore_errors=True)

    def channel(path, provider, device_mvcc, name=CONFIG2_CHANNEL):
        return Channel(name, str(root / path), net.managers[False], registry, provider,
                       device_mvcc=device_mvcc, device=dev)

    def reset(*tables):
        for table in tables:
            for k in table:
                table[k] = 0

    def serial(ch, blocks):
        """store_block one block at a time: each block's (filter, COMMIT_HASH
        slot, MVCC route, commit split) and the wall seconds."""
        out = []
        t0 = time.perf_counter()
        for raw in blocks:
            b = wire.decode(fabric.BLOCK, raw)
            flags = ch.store_block(b)
            out.append((flags.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH],
                        ch.ledger.last_mvcc_path, {**ch.last_prepare_ms, **split(ch)}))
        return out, time.perf_counter() - t0

    def split(ch):
        """A committed block's stage-B split in ms on the host clock: the
        channel's steps, the validator's epilogue, the ledger's commit."""
        return {**ch.last_store_ms,
                **{f"validator_{k}": v for k, v in ch.validator.last_ms.items()},
                **{k: v * 1e3 for k, v in ch.ledger.last_commit_timings.items()}}

    def full_gc_counter():
        count = [0]

        def on_gc(phase, info):
            if phase == "start" and info["generation"] == 2:
                count[0] += 1

        return count, on_gc

    def batcher_state(bp, obs):
        """The shared batcher's launches, its transport mode and round-trip
        estimate, and the obs counters of retried and fail-closed
        dispatches."""
        return {"launches": bp.batcher.launches, "lanes": bp.batcher.lanes,
                "mode": bp.batcher.mode, "rtt_ema_ms": bp.batcher.rtt_ema_ms,
                "dispatch_retries": obs.value("fabric_batcher_dispatch_retries_total"),
                "fail_closed": obs.value("fabric_batcher_fail_closed_total")}

    try:
        # --- pipeline_config2: 10 linked blocks, two stages, K2 and K5 -------
        with fabobs.obs_installed() as obs:
            recorder = recording_cuda_provider(dev)
            bp = BatchingProvider(recorder)
            ch = channel("pipelined", bp, True)
            committed, prepared = [], []
            pipe = CommitPipeline(ch, depth=PIPELINE_DEPTH, on_commit=lambda b, f: committed.append(
                (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH],
                 ch.ledger.last_mvcc_path, split(ch))))
            blocks = [wire.decode(fabric.BLOCK, raw) for raw in raws]
            deliver_error = []

            def deliver():
                try:
                    for b in blocks:
                        pipe.submit(b)
                        prepared.append(dict(ch.last_prepare_ms))
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    deliver_error.append(exc)

            reset(p256k.LAUNCHES, md.LAUNCHES)
            gcs, on_gc = full_gc_counter()
            gc.callbacks.append(on_gc)
            try:
                t0 = time.perf_counter()
                deliver_thread = threading.Thread(target=deliver, name="deliver")
                deliver_thread.start()
                deliver_thread.join()
                drained = pipe.drain(timeout=300)
                wall = time.perf_counter() - t0
            finally:
                gc.callbacks.remove(on_gc)
            launches = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                        "p256_key_tables": p256k.LAUNCHES["p256_key_tables"],
                        "p256_verify_limbs": p256k.LAUNCHES["p256_verify_limbs"],
                        **k5_launches(md), **k6_launches(md)}
            stats, dead, last_error = pipe.stage_stats(), pipe.dead, pipe.last_error
            pipe.stop()
            bp.stop()
            batcher = batcher_state(bp, obs)
            ch.ledger.close()
        if deliver_error or not drained or dead or last_error is not None:
            raise AssertionError(f"pipeline_config2: drained {drained}, dead {dead}, last_error "
                                 f"{last_error!r}, deliver {deliver_error!r}")
        k2_held = hold_k2_lanes(torch, p256k, recorder.records, oracle, rng, n_flipped,
                                oracle_sample, "pipeline_config2")
        if keep is not None:
            keep.setdefault("k2_records", {})["pipeline_config2"] = lane_records(recorder)

        # the same chain stored one block at a time: the same provider and
        # MVCC route without the pipeline and the batcher
        ch_serial = channel("serial", CUDAProvider(device=dev), True)
        serial_out, serial_wall = serial(ch_serial, raws)
        ch_serial.ledger.close()
        # one block at a time, MVCC on the host
        ch_ref = channel("reference", CUDAProvider(device=dev), False)
        ref_out, ref_wall = serial(ch_ref, raws)
        ch_ref.ledger.close()

        got = [(f, h) for f, h, _, _ in committed]
        if ([f for f, _ in got] != want_codes or got != [(f, h) for f, h, _, _ in ref_out]
                or got != [(f, h) for f, h, _, _ in serial_out]):
            raise AssertionError("pipeline_config2: filters or commit hashes differ from the "
                                 "serial runs or the expected codes")
        chain_bytes = {run: (root / run / f"{CONFIG2_CHANNEL}.chain").read_bytes()
                       for run in ("pipelined", "serial", "reference")}
        rows = {run: ledger_rows(root / run / f"{CONFIG2_CHANNEL}.state.db")
                for run in ("pipelined", "serial", "reference")}
        if len(set(chain_bytes.values())) != 1 or not rows["pipelined"] == rows["serial"] == rows[
                "reference"]:
            raise AssertionError("pipeline_config2: .chain bytes or SQLite rows differ")
        paths = [p for _, _, p, _ in committed]
        if paths != ["device"] * n_blocks or [p for _, _, p, _ in serial_out] != paths:
            raise AssertionError(f"pipeline_config2: MVCC routes {paths}")
        if (launches["mvcc_resolve"] != n_blocks or launches["mvcc_resolve_global"]
                or not 1 <= launches["p256_verify_bytes"] <= n_blocks
                or launches["p256_verify_bytes"] != len(recorder.records)
                or launches["p256_key_tables"] != 1 or launches["p256_verify_limbs"]
                or any(launches[r] for r in K6_ROUTES)):
            raise AssertionError(f"pipeline_config2 launches: {launches}")
        if batcher["launches"] < 1 or batcher["dispatch_retries"] or batcher["fail_closed"]:
            raise AssertionError(f"pipeline_config2: batcher {batcher}")
        reopened = KVLedger(str(root / "pipelined"), CONFIG2_CHANNEL, device_mvcc=True, device=dev)
        reopen = {"height": reopened.height, "replayed": reopened.recovered_blocks,
                  "commit_hash_equal": reopened.commit_hash == wire.decode(
                      fabric.METADATA, got[-1][1])["value"]}
        reopened.close()
        if reopen != {"height": n_blocks, "replayed": 0, "commit_hash_equal": True}:
            raise AssertionError(f"pipeline_config2: reopen {reopen}")
        stage_s = {k: v["mean_ms"] * v["n"] / 1e3 for k, v in stats.items()}
        txs = n_blocks * n_txs
        if keep is not None:
            keep["pipeline_config2"] = {"committed": got, "ms_per_block": wall / n_blocks * 1e3}
        emit({"phase": "pipeline_config2", "blocks": n_blocks, "txs_per_block": n_txs,
              "depth": PIPELINE_DEPTH, "setup_seconds": setup_s,
              "pipelined": {"seconds": wall, "tx_per_s": txs / wall,
                            "ms_per_block": wall / n_blocks * 1e3, "full_gcs": gcs[0]},
              "serial": {"seconds": serial_wall, "tx_per_s": txs / serial_wall,
                         "ms_per_block": serial_wall / n_blocks * 1e3},
              "reference_host_mvcc": {"seconds": ref_wall, "tx_per_s": txs / ref_wall,
                                      "ms_per_block": ref_wall / n_blocks * 1e3},
              "stage_stats": stats, "stage_seconds": stage_s,
              "overlap_share": (stage_s["prepare"] + stage_s["commit"]) / wall,
              "prepare_split_ms": prepared,
              "store_split_ms": [t for _, _, _, t in committed],
              "serial_split_ms": [t for _, _, _, t in serial_out],
              "launches": launches, "batcher": batcher,
              "conflicts": {conflict_block: n_txs // 10}, "flipped_signatures": n_flipped,
              "mvcc_routes": paths, "equal_to_serial_and_reference": True,
              "k2_lanes_held": k2_held, "reopen": reopen,
              "seconds": time.perf_counter() - t_phase})

        # --- pipeline_config5: four channels, one shared BatchingProvider ----
        t5 = time.perf_counter()
        alone = {}
        for name in channels5:
            c = channel(f"alone-{name}", CUDAProvider(device=dev), False, name)
            alone[name] = [(f, h) for f, h, _, _ in serial(c, chains[name])[0]]
            c.ledger.close()
        with fabobs.obs_installed() as obs:
            recorder5 = recording_cuda_provider(dev)
            bp = BatchingProvider(recorder5)
            pipes, out5, splits5, errors = {}, {name: [] for name in channels5}, {}, []
            for name in channels5:
                c = channel(f"shared-{name}", bp, True, name)
                splits5[name] = {"prepare": [], "store": []}

                def on_commit(b, f, n=name, c=c):
                    out5[n].append((f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH]))
                    splits5[n]["store"].append(split(c))

                pipes[name] = CommitPipeline(c, depth=PIPELINE_DEPTH, on_commit=on_commit,
                                             on_error=lambda b, exc: errors.append(exc))
            decoded = {name: [wire.decode(fabric.BLOCK, raw) for raw in chains[name]]
                       for name in channels5}

            def deliver5(name):
                try:
                    for b in decoded[name]:
                        pipes[name].submit(b)
                        splits5[name]["prepare"].append(dict(pipes[name].channel.last_prepare_ms))
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    errors.append(exc)

            reset(p256k.LAUNCHES, md.LAUNCHES)
            gcs5, on_gc = full_gc_counter()
            gc.callbacks.append(on_gc)
            try:
                t0 = time.perf_counter()
                threads = [threading.Thread(target=deliver5, args=(n,), name=f"deliver-{n}")
                           for n in channels5]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                drained = all(p.drain(timeout=300) for p in pipes.values())
                wall5 = time.perf_counter() - t0
            finally:
                gc.callbacks.remove(on_gc)
            launches5 = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                         "p256_key_tables": p256k.LAUNCHES["p256_key_tables"],
                         "p256_verify_limbs": p256k.LAUNCHES["p256_verify_limbs"],
                         **k5_launches(md)}
            stats5 = {n: p.stage_stats() for n, p in pipes.items()}
            for p in pipes.values():
                p.stop()
                p.channel.ledger.close()
            bp.stop()
            batcher5 = batcher_state(bp, obs)
        if errors or not drained or any(out5[n] != alone[n] for n in channels5):
            raise AssertionError(f"pipeline_config5: drained {drained}, errors {errors!r}, or a "
                                 "channel differs from the channel alone")
        if any([f for f, _ in out5[n]] != want5[n] for n in channels5):
            raise AssertionError("pipeline_config5: filters differ from the expected codes")
        blocks5 = n_channels * config5_blocks
        if (launches5["mvcc_resolve"] != blocks5 or launches5["mvcc_resolve_global"]
                or not 1 <= launches5["p256_verify_bytes"] < blocks5
                or launches5["p256_verify_bytes"] != len(recorder5.records)
                or launches5["p256_key_tables"] != 1 or launches5["p256_verify_limbs"]):
            # fewer K2 launches than blocks: at least one launch coalesced
            # two channels' blocks, whose verdicts the filters then hold
            raise AssertionError(f"pipeline_config5 launches: {launches5}")
        if batcher5["dispatch_retries"] or batcher5["fail_closed"]:
            raise AssertionError(f"pipeline_config5: batcher {batcher5}")
        k2_held5 = hold_k2_lanes(torch, p256k, recorder5.records, oracle, rng, n_flipped5,
                                 oracle_sample, "pipeline_config5")
        if keep is not None:
            keep.setdefault("k2_records", {})["pipeline_config5"] = lane_records(recorder5)
        txs5 = blocks5 * config5_txs
        emit({"phase": "pipeline_config5", "channels": n_channels, "blocks_per_channel":
              config5_blocks, "txs_per_block": config5_txs, "seconds": wall5,
              "aggregate_tx_per_s": txs5 / wall5, "blocks_submitted": blocks5,
              "batcher": batcher5, "launches": launches5, "full_gcs": gcs5[0],
              "stage_stats": stats5, "split_ms": splits5, "flipped_signatures": n_flipped5,
              "equal_to_each_channel_alone": True, "k2_lanes_held": k2_held5,
              "seconds_with_alone_runs": time.perf_counter() - t5})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


SNAPSHOT_AT = 5  # the snapshot's ledger height: blocks 0-4 before it, 5-9 after
SNAPSHOT_HISTORY_KEYS = 8  # benchcc keys whose history the joined peer resolves


def seed_snapshot_ledger(path, n_keys: int, n_hashed: int, policy) -> float:
    """A fresh ledger at `path` seeded before block 0 through
    `state_db.apply_updates`, the call `create_from_snapshot` makes:
    mvcc_resident_chain's state (`n_keys` public keys and `n_hashed` hashed
    keys of coll0 under cc) and benchcc's committed `_lifecycle` definition,
    written by the port's LifecycleResources: sequence 1, validation plugin
    "guard", `policy` as its validation parameter, coll0 at BTL 0. Returns
    the seconds it took."""
    from fabric_tpu_torch.ledger import rwset as rw
    from fabric_tpu_torch.ledger.collections import build_collection_config_package
    from fabric_tpu_torch.ledger.kvledger import KVLedger
    from fabric_tpu_torch.ledger.statedb import HashedUpdateBatch, UpdateBatch
    from fabric_tpu_torch.lifecycle import NAMESPACE, ChaincodeDefinition, LifecycleResources
    from fabric_tpu_torch.policy.proto_convert import marshal_application_policy
    from fabric_tpu_torch.protos import fabric, wire

    t0 = time.perf_counter()
    updates, hashed = UpdateBatch(), HashedUpdateBatch()
    for i in range(n_keys):
        updates.put("cc", ChainTraffic.key(i), b"v0", rw.Version(0, i))
    for i in range(n_hashed):
        kh = ChainTraffic.key_hash(i)
        hashed.put("cc", "coll0", kh, hashlib.sha256(kh).digest(), rw.Version(0, i))
    public, approvals = {}, {}
    orgs = ["Org1MSP", "Org2MSP", "Org3MSP"]
    resources = LifecycleResources(public.get, public.__setitem__,
                                   lambda org, k: approvals.get((org, k)),
                                   lambda org, k, v: approvals.__setitem__((org, k), v), orgs)
    package = build_collection_config_package([{"name": "coll0", "policy": CONFIG2_POLICY,
                                                "block_to_live": 0}])
    definition = ChaincodeDefinition(
        sequence=1, validation_plugin="guard",
        validation_parameter=marshal_application_policy(policy),
        collections=wire.encode(fabric.COLLECTION_CONFIG_PACKAGE, package))
    for org in orgs:
        resources.approve_chaincode_definition_for_org(org, "benchcc", definition)
    resources.commit_chaincode_definition("benchcc", definition)
    for key, value in sorted(public.items()):
        updates.put(NAMESPACE, key, value, rw.Version(0, 0))
    ledger = KVLedger(str(path), CONFIG2_CHANNEL)
    try:
        ledger.state_db.apply_updates(updates, hashed)
    finally:
        ledger.close()
    return time.perf_counter() - t0


def lifecycle_view(state_get):
    """A read-only view of `_lifecycle` over `state_get(ns, key)`."""
    from fabric_tpu_torch.lifecycle import NAMESPACE, LifecycleResources

    def refuse(*_):
        raise RuntimeError("the view is read-only")

    return LifecycleResources(lambda key: state_get(NAMESPACE, key), refuse,
                              lambda org, key: None, refuse, [])


def guard_plugin():
    """The `"guard"` validation plugin of the joined peer: it records each
    context's signers' verdicts, runs the default check (the definition's
    policy over the batch's verdicts, `_eval_policy_host` once a tx) and
    refuses the tx when it fails; `seconds` holds its time by block."""
    from fabric_tpu_torch.validation.plugin_api import EndorsementInvalid, ValidationPlugin

    class Guard(ValidationPlugin):
        def __init__(self):
            self.seen = []
            self.seconds = {}

        def validate(self, ctx):
            t0 = time.perf_counter()
            try:
                self.seen.append((ctx.block_num, ctx.tx_index, ctx.namespace,
                                  tuple(s.sig_valid for s in ctx.signers)))
                if not ctx.default_check():
                    raise EndorsementInvalid("benchcc's endorsement policy is not met")
            finally:
                self.seconds[ctx.block_num] = (self.seconds.get(ctx.block_num, 0.0)
                                               + time.perf_counter() - t0)

    return Guard()


def snapshot_phase(torch, np, dev, net, raws, n_keys=CHAIN_KEYS, n_hashed=CHAIN_HASHED_KEYS,
                   n_txs=CONFIG2_TXS, conflict_block=PIPELINE_CONFLICT_BLOCK, at=SNAPSHOT_AT,
                   flipped=PIPELINE_FLIPPED, oracle_sample=ORACLE_SAMPLE) -> dict:
    """snapshot_config2: pipeline_config2's signed chain (`raws`, `net`'s)
    committed by two source ledgers seeded alike, A pipelined (K2, K5) and
    A' one block at a time (host MVCC), each snapshot at height `at`; a peer
    J joins from A's snapshot and commits the rest pipelined through K2, the
    key combs and K5, its definitions read from the `_lifecycle` state the
    snapshot carried and its txs validated by the "guard" plugin; a peer J'
    joins from A's twin and commits one block at a time with the static
    registry and the host MVCC; A goes on uninterrupted. Returns the
    launches of K2, the key combs and K5 on J, for the kernels line."""
    import random
    import shutil
    import threading
    from pathlib import Path

    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ledger.blockstore import BlockStore
    from fabric_tpu_torch.ledger.collections import CollectionStore
    from fabric_tpu_torch.ledger.history import get_history_for_key
    from fabric_tpu_torch.ledger.kvledger import KVLedger
    from fabric_tpu_torch.common.txflags import TxValidationCode as V
    from fabric_tpu_torch.ledger import snapshot as snapshot_mod
    from fabric_tpu_torch.ledger.snapshot import (
        SnapshotRequestManager, create_from_snapshot, verify_snapshot)
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.parallel.batcher import BatchingProvider
    from fabric_tpu_torch.peer.channel import Channel
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.protos import fabric, protoutil, wire
    from fabric_tpu_torch.validation.dispatcher import LifecycleRegistry, PluginRegistry
    from fabric_tpu_torch.validation.legacy import LSCCRegistry, ValidationRouter
    from fabric_tpu_torch.validation.validator import ChaincodeDefinition, ChaincodeRegistry

    t_phase = time.perf_counter()
    n_blocks = len(raws)
    want_codes = [net.chain_codes(number, n_txs, number == conflict_block, CONFIG2_CHANNEL,
                                  flipped) for number in range(n_blocks)]
    static = ChaincodeRegistry([ChaincodeDefinition("benchcc", net.policy)])
    root = Path(__file__).resolve().parent / "build" / "smoke_snapshots"
    shutil.rmtree(root, ignore_errors=True)
    seconds = {}

    def channel(path, provider, device_mvcc, registry=static, **kw):
        """A Channel over `path` whose btl_policy reads the collections of
        the `_lifecycle` definitions in its own ledger's state."""
        holder = {}
        view = lifecycle_view(lambda ns, key: holder["ledger"].get_state(ns, key))
        store = CollectionStore(lambda ns: getattr(view.query_chaincode_definition(ns),
                                                   "collections", b""))
        ch = Channel(CONFIG2_CHANNEL, str(root / path), net.managers[False], registry, provider,
                     btl_policy=store.btl_policy(), device_mvcc=device_mvcc, device=dev, **kw)
        holder["ledger"] = ch.ledger
        return ch, store

    def serial(ch, blocks, after=None):
        out = []
        t0 = time.perf_counter()
        for raw in blocks:
            b = wire.decode(fabric.BLOCK, raw)
            out.append((ch.store_block(b).tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH]))
            if after is not None:
                after()
        return out, time.perf_counter() - t0

    def pipelined(ch, blocks, on_commit=None):
        """The blocks through CommitPipeline(depth=2) from a deliver thread:
        each block's (filter, COMMIT_HASH slot), the wall seconds and the
        full collections during the run."""
        committed, errors = [], []

        def record(b, f):
            committed.append((f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH]))
            if on_commit is not None:
                on_commit()

        pipe = CommitPipeline(ch, depth=PIPELINE_DEPTH, on_commit=record,
                              on_error=lambda b, exc: errors.append(exc))
        decoded = [wire.decode(fabric.BLOCK, raw) for raw in blocks]

        def deliver():
            try:
                for b in decoded:
                    pipe.submit(b)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        full = [0]

        def on_gc(phase, info):
            if phase == "start" and info["generation"] == 2:
                full[0] += 1

        gc.callbacks.append(on_gc)
        try:
            t0 = time.perf_counter()
            thread = threading.Thread(target=deliver, name="deliver")
            thread.start()
            thread.join()
            drained = pipe.drain(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(on_gc)
            pipe.stop()
        if errors or not drained or pipe.dead or pipe.last_error is not None:
            raise AssertionError(f"snapshot_config2: drained {drained}, errors {errors!r}, "
                                 f"last_error {pipe.last_error!r}")
        return committed, wall, full[0]

    def snapshot_files(path):
        """The snapshot's three data files and its signable metadata."""
        return {name: (Path(path) / name).read_bytes() for name in (
            snapshot_mod.PUBLIC_STATE, snapshot_mod.PVT_HASHES, snapshot_mod.TXIDS,
            snapshot_mod.SIGNABLE_METADATA)}

    try:
        # --- two source ledgers seeded alike ---------------------------------
        seconds["seed"] = seed_snapshot_ledger(root / "A", n_keys, n_hashed, net.policy)
        t0 = time.perf_counter()
        shutil.copytree(root / "A", root / "A2")
        seconds["seed_copy"] = time.perf_counter() - t0

        # A: the whole chain pipelined, its snapshot taken on the committer
        # thread once block at-1 is in
        bp_a = BatchingProvider(CUDAProvider(device=dev))
        ch_a, _ = channel("A", bp_a, True)
        mgr_a = SnapshotRequestManager(ch_a.ledger, str(root / "snapshots-A"))
        mgr_a.submit(at - 1)

        def export_a():
            t = time.perf_counter()
            mgr_a.on_block_committed(wait=True)  # exports once block at-1 is in
            if ch_a.ledger.height == at:
                seconds["export_A"] = time.perf_counter() - t

        out_a, wall_a, _ = pipelined(ch_a, raws, export_a)
        bp_a.stop()
        ch_a.ledger.close()
        # A': the blocks before the snapshot one at a time, host MVCC
        ch_a2, _ = channel("A2", CUDAProvider(device=dev), False)
        mgr_a2 = SnapshotRequestManager(ch_a2.ledger, str(root / "snapshots-A2"))
        mgr_a2.submit(at - 1)

        def export_a2():
            t = time.perf_counter()
            mgr_a2.on_block_committed(wait=True)
            if ch_a2.ledger.height == at:
                seconds["export_A2"] = time.perf_counter() - t

        out_a2, _ = serial(ch_a2, raws[:at], export_a2)
        ch_a2.ledger.close()
        snap_a, snap_a2 = mgr_a.generated.get(at - 1), mgr_a2.generated.get(at - 1)
        if snap_a is None or snap_a2 is None or mgr_a.pending() or mgr_a2.pending():
            raise AssertionError("snapshot_config2: a snapshot was not taken")
        meta = verify_snapshot(snap_a)
        if meta != verify_snapshot(snap_a2) or snapshot_files(snap_a) != snapshot_files(snap_a2):
            raise AssertionError("snapshot_config2: the two snapshots differ")
        if meta["last_block_number"] != at - 1 or out_a[:at] != out_a2:
            raise AssertionError(f"snapshot_config2: snapshot metadata {meta} or the sources' "
                                 "filters differ")
        snap_bytes = sum(len(v) for v in snapshot_files(snap_a).values())

        # --- join: J from A's snapshot, J' from A''s ---------------------------
        for name, snap in (("J", snap_a), ("J2", snap_a2)):
            t = time.perf_counter()
            create_from_snapshot(snap, str(root / name)).close()
            seconds[f"import_{name}"] = time.perf_counter() - t
        plugins = PluginRegistry()
        guard = guard_plugin()
        plugins.register("guard", guard)
        holder = {}

        def state_get(ns, key):
            return holder["ledger"].get_state(ns, key)

        lscc = LSCCRegistry(state_get)
        router = ValidationRouter(LifecycleRegistry(state_get, legacy=lscc, plugin_registry=plugins),
                                  lscc, lambda: ["V2_0"])
        recorder = recording_cuda_provider(dev)
        bp_j = BatchingProvider(recorder)
        ch_j, store_j = channel("J", bp_j, True, registry=router, plugin_registry=plugins)
        holder["ledger"] = ch_j.ledger
        ch_j2, store_j2 = channel("J2", CUDAProvider(device=dev), False)
        joined = {"heights": (ch_j.ledger.height, ch_j2.ledger.height),
                  "replayed": (ch_j.ledger.recovered_blocks, ch_j2.ledger.recovered_blocks),
                  "btl_coll0": (store_j.btl_policy()("benchcc", "coll0"),
                                store_j2.btl_policy()("benchcc", "coll0")),
                  "has_coll0": store_j.has_collection("benchcc", "coll0"),
                  "definition_plugin": router.get("benchcc").plugin}
        if joined != {"heights": (at, at), "replayed": (0, 0), "btl_coll0": (0, 0),
                      "has_coll0": True, "definition_plugin": "guard"}:
            raise AssertionError(f"snapshot_config2: joined peers {joined}")

        # --- blocks at.. on J (pipelined, K2, the key combs, K5) and J' ---------
        for table in (p256k.LAUNCHES, md.LAUNCHES):
            for k in table:
                table[k] = 0
        out_j, wall_j, gcs_j = pipelined(ch_j, raws[at:])
        launches = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                    "p256_key_tables": p256k.LAUNCHES["p256_key_tables"],
                    "p256_verify_limbs": p256k.LAUNCHES["p256_verify_limbs"],
                    **k5_launches(md), **k6_launches(md)}
        out_j2, wall_j2 = serial(ch_j2, raws[at:])
        codes = {"J": [f for f, _ in out_j], "J2": [f for f, _ in out_j2],
                 "A": [f for f, _ in out_a[at:]], "expected": want_codes[at:]}
        if len({tuple(v) for v in codes.values()}) != 1:
            raise AssertionError("snapshot_config2: filters differ among J, J', A and the "
                                 "expected codes")
        if [h for _, h in out_j] != [h for _, h in out_j2]:
            raise AssertionError("snapshot_config2: J's and J''s commit hashes differ")
        if (launches["p256_verify_bytes"] < 1 or launches["p256_key_tables"] < 1
                or launches["mvcc_resolve"] + launches["mvcc_resolve_global"] != n_blocks - at
                or launches["p256_verify_limbs"] or any(launches[r] for r in K6_ROUTES)):
            raise AssertionError(f"snapshot_config2 launches on J: {launches}")
        # the state after the last block: J's rows equal A's
        state_tables = ("state", "hashed")
        if (ledger_rows(root / "J" / f"{CONFIG2_CHANNEL}.state.db", state_tables)
                != ledger_rows(root / "A" / f"{CONFIG2_CHANNEL}.state.db", state_tables)):
            raise AssertionError("snapshot_config2: J's state rows differ from A's")
        # J's frames are A's but for the COMMIT_HASH slot
        store_a = BlockStore(str(root / "A" / f"{CONFIG2_CHANNEL}.chain"))
        try:
            for number in range(at, n_blocks):
                blocks = [store_a.get_block_by_number(number),
                          ch_j.ledger.block_store.get_block_by_number(number)]
                hashes = [b["metadata"]["metadata"][fabric.COMMIT_HASH] for b in blocks]
                for b in blocks:
                    b["metadata"]["metadata"][fabric.COMMIT_HASH] = b""
                if wire.encode(fabric.BLOCK, blocks[0]) != wire.encode(fabric.BLOCK, blocks[1]):
                    raise AssertionError(f"snapshot_config2: J's block {number} differs from A's")
                if hashes[0] == hashes[1]:
                    raise AssertionError("snapshot_config2: the commit hash did not restart")
        finally:
            store_a.close()
        # history: J resolves A's entries from the blocks after the join
        ledger_a = KVLedger(str(root / "A"), CONFIG2_CHANNEL)
        rng = random.Random(CONFIG2_SEED + at)
        keys = [f"k{i}" for i in sorted(rng.sample(range(n_txs), SNAPSHOT_HISTORY_KEYS - 2))]
        # the key of the conflict block's last conflicting tx, and tx 3's (the
        # txs i % 10 == 3 are the ones that may carry a flipped signature)
        keys += [f"k{n_txs - 1}", "k3"]
        try:
            history = {}
            for key in keys:
                got = [(m.tx_id, (m.version.block_num, m.version.tx_num), m.value, m.is_delete)
                       for m in get_history_for_key(ch_j.ledger, "benchcc", key)]
                want = [(m.tx_id, (m.version.block_num, m.version.tx_num), m.value, m.is_delete)
                        for m in get_history_for_key(ledger_a, "benchcc", key)
                        if m.version.block_num >= at]
                if got != want:
                    raise AssertionError(f"snapshot_config2: history of {key} differs")
                history[key] = len(got)
        finally:
            ledger_a.close()
        if not any(history.values()):
            raise AssertionError(f"snapshot_config2: history entries {history}")

        # --- a pre-snapshot tx resubmitted: block n_blocks on J and J' ---------
        pre = min(2, at - 1)  # a block before the snapshot
        old = wire.decode(fabric.BLOCK, raws[pre])["data"]["data"][0]
        txid = wire.decode(fabric.CHANNEL_HEADER, wire.decode(fabric.PAYLOAD, wire.decode(
            fabric.ENVELOPE, old)["payload"])["header"]["channel_header"])["tx_id"]
        dup = Config2Net.make_block([old], n_blocks, ch_j.ledger.block_store.last_block_hash)
        dup_raw = wire.encode(fabric.BLOCK, dup)
        pretxids = (root / "J" / f"{CONFIG2_CHANNEL}.chain.pretxids").read_text().split()
        dup_j, _, _ = pipelined(ch_j, [dup_raw])
        dup_j2, _ = serial(ch_j2, [dup_raw])
        duplicate = bytes([V.DUPLICATE_TXID])
        if (dup_j[0][0] != duplicate or dup_j2[0] != dup_j[0] or txid not in pretxids
                or ch_j.ledger.block_store.get_block_by_number(pre) is not None):
            raise AssertionError(f"snapshot_config2: the resubmitted tx {txid} was not "
                                 "DUPLICATE_TXID through the .pretxids sidecar")
        bp_j.stop()
        ch_j.ledger.close()
        ch_j2.ledger.close()
        if ((root / "J" / f"{CONFIG2_CHANNEL}.chain").read_bytes()
                != (root / "J2" / f"{CONFIG2_CHANNEL}.chain").read_bytes()
                or ledger_rows(root / "J" / f"{CONFIG2_CHANNEL}.state.db")
                != ledger_rows(root / "J2" / f"{CONFIG2_CHANNEL}.state.db")):
            raise AssertionError("snapshot_config2: J's and J''s .chain or SQLite rows differ")

        # --- the plugin against K2's verdicts ------------------------------------
        k2_held = hold_k2_lanes(torch, p256k, recorder.records, oracle_provider(),
                                random.Random(CONFIG2_SEED + 1), sum(
                                    len(net.flipped(number, n_txs, CONFIG2_CHANNEL, flipped))
                                    for number in range(at, n_blocks)), oracle_sample,
                                "snapshot_config2")
        refused_sigs = {r["sigs"][i] for r in recorder.records
                        for i, ok in enumerate(r["verdicts"]) if not ok}
        consulted, plugin_false, refused_lanes = [], set(), set()
        for number, raw in enumerate(raws[at:] + [dup_raw], start=at):
            b = wire.decode(fabric.BLOCK, raw)
            final = out_j[number - at][0] if number < n_blocks else dup_j[0][0]
            for i, data in enumerate(b["data"]["data"]):
                # the txs that reach the plugin: MVCC comes after validation
                if final[i] in (V.VALID, V.ENDORSEMENT_POLICY_FAILURE, V.MVCC_READ_CONFLICT):
                    consulted.append((number, i))
                env = wire.decode(fabric.ENVELOPE, data)
                tx = wire.decode(fabric.TRANSACTION, wire.decode(fabric.PAYLOAD,
                                                                  env["payload"])["data"])
                cap = wire.decode(fabric.CHAINCODE_ACTION_PAYLOAD, tx["actions"][0]["payload"])
                for j, e in enumerate(cap["action"]["endorsements"]):
                    if e["signature"] in refused_sigs and final[i] != V.BAD_CREATOR_SIGNATURE:
                        refused_lanes.add((number, i, j))
        for number, i, ns, valid in guard.seen:
            plugin_false |= {(number, i, j) for j, ok in enumerate(valid) if not ok}
        seen_txs = [(number, i) for number, i, _, _ in guard.seen]
        if (plugin_false != refused_lanes or not refused_lanes
                or sorted(seen_txs) != sorted(consulted) or len(set(seen_txs)) != len(seen_txs)
                or {ns for _, _, ns, _ in guard.seen} != {"benchcc"}):
            raise AssertionError(
                f"snapshot_config2: the plugin saw {len(plugin_false)} refused lanes, K2 refused "
                f"{len(refused_lanes)} endorsement lanes of consulted txs; consulted "
                f"{len(seen_txs)} times for {len(consulted)} txs")
        plugin_ms = [guard.seconds.get(number, 0.0) * 1e3 for number in range(at, n_blocks)]
        emit({"phase": "snapshot_config2", "seed_keys": n_keys, "seed_hashed_keys": n_hashed,
              "snapshot_at_height": at, "blocks_after": n_blocks - at, "txs_per_block": n_txs,
              "snapshot_bytes": snap_bytes, "seconds_split": seconds,
              "J_pipelined": {"seconds": wall_j, "ms_per_block": wall_j / (n_blocks - at) * 1e3,
                              "full_gcs": gcs_j},
              "J2_serial": {"seconds": wall_j2, "ms_per_block": wall_j2 / (n_blocks - at) * 1e3},
              "A_pipelined_ms_per_block": wall_a / n_blocks * 1e3,
              "A_pipelined_ms_per_block_without_export": (
                  wall_a - seconds["export_A"]) / n_blocks * 1e3,
              "plugin_ms_per_block": plugin_ms, "plugin_calls": len(guard.seen),
              "plugin_refused_lanes": len(plugin_false), "launches_on_J": launches,
              "k2_lanes_held": k2_held, "history_entries": history, "joined": joined,
              "duplicate_txid": txid, "equal": True,
              "seconds": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# config_update_config2: a config update that adds Org4, inside a config #2
# chain (channelconfig, the policy manager and ACLs on the card)
# ---------------------------------------------------------------------------

CONFIG_SEED = CONFIG2_SEED + 12  # the orderer org's and Org4's material
CONFIG_BLOCK = 5  # the CONFIG block: blocks 1-4 before it, 6-10 after
CONFIG_ORG4_TXS = 10  # Org4 client txs in the block before it and in each from CONFIG_ORG4_FROM
CONFIG_ORG4_FROM = 7  # the first block whose Org4 txs must be VALID
CONFIG_ACL = ("event/Block", "/Channel/Application/Writers")  # the ACL the update overrides
APPLICATION_ADMINS = "/Channel/Application/Admins"
# the padded width of one config #2 block's K2 launch, which pipeline_config2
# always holds against its plain version (wider when its batcher coalesces)
K2_HELD_PADDED_LANES = 4096
ACL_THREADS = 16  # concurrent ACL checks through the shared batcher


class ConfigNet:
    """The network of config_update_config2 beside `Config2Net`'s Org1-3
    (bench.py `_Net`, 314-388): an orderer org whose orderer signs the CONFIG
    tx, and Org4MSP with its client, both minted by the port's cryptogen from
    CONFIG_SEED; the admins of Org1-3 sign the update. `profile` is the
    genesis profile for an encoder module (the port's, or any with the same
    dataclasses), `to_msp` mapping the port's MSPConfig to that module's."""

    def __init__(self, net, seed=CONFIG_SEED):
        import random

        from fabric_tpu_torch.msp.cryptogen import generate_org
        from fabric_tpu_torch.msp.signer import SigningIdentity

        rng = random.Random(seed)
        self.net = net
        self.rng = rng
        self.orderer_org = generate_org("orderer.bench", "OrdererMSP", rng=rng)
        self.orderer = SigningIdentity(
            self.orderer_org.ca.enroll("orderer0.orderer.bench", ou="orderer"), rng)
        self.org4 = generate_org("org4.bench", "Org4MSP", rng=rng)
        self.org4_client = SigningIdentity(self.org4.users[0], rng)
        self.admins = [SigningIdentity(o.admin, rng) for o in net.orgs]
        # a client of each of Org1-4, for the event/Block checks
        self.clients = [net.client] + [SigningIdentity(o.users[0], rng) for o in net.orgs[1:]] + [
            self.org4_client]

    @staticmethod
    def channel_acls():
        """The default ACLs that name a channel policy, as configtxgen's
        sample profile carries them in the Application group."""
        from fabric_tpu_torch.peer.aclmgmt import DEFAULT_ACLS

        return {k: v for k, v in DEFAULT_ACLS.items() if v.startswith("/")}

    def profile(self, enc, to_msp=lambda c: c, **ordering):
        """Solo orderer with the orderer org; Application Org1-3 with anchor
        peers, the encoder's sample policies (Readers and Writers ANY,
        Admins and Endorsement MAJORITY), the default ACLs, V2_0.
        `ordering` overrides OrdererProfile's fields (orderer_type,
        raft_consenters, the BatchSize)."""
        orgs = [enc.OrganizationProfile(o.msp_id, to_msp(o.msp_config()),
                                        anchor_peers=[(f"peer0.org{i}.bench", 7051)])
                for i, o in enumerate(self.net.orgs, start=1)]
        orderer = enc.OrganizationProfile("OrdererMSP", to_msp(self.orderer_org.msp_config()),
                                          orderer_endpoints=["orderer0.orderer.bench:7050"])
        return enc.Profile(
            application=enc.ApplicationProfile(organizations=orgs, acls=self.channel_acls()),
            orderer=enc.OrdererProfile(**{"orderer_type": "solo",
                                          "addresses": ["orderer0.orderer.bench:7050"],
                                          "organizations": [orderer], **ordering}))

    def genesis(self, channel, **ordering):
        """The genesis block of `profile(encoder)` (the port's encoder), with
        one change: the Application group's mod policy is written absolute,
        "/Channel/Application/Admins", which names the policy Fabric resolves
        the relative "Admins" of that group to. Both packages resolve a new
        element's inherited relative mod policy against the new element's own
        path (channelconfig/configtx.py, `_new_item_mod_policy` and
        `_authorize`), so under the encoder's "Admins" no update can add an
        org: its MSP value asks for /Channel/Application/Org4MSP/Admins,
        which does not exist (tests/test_torch_channelconfig.py pins that in
        both). `ordering` as for `profile`."""
        from fabric_tpu_torch.channelconfig import encoder
        from fabric_tpu_torch.protos import configtx as cfgpb
        from fabric_tpu_torch.protos import fabric, protoutil, wire

        config = encoder.new_config(self.profile(encoder, **ordering))
        config["channel_group"]["groups"]["Application"]["mod_policy"] = APPLICATION_ADMINS
        chdr = wire.encode(fabric.CHANNEL_HEADER, protoutil.make_channel_header(
            fabric.CONFIG, channel))
        payload = {"header": {"channel_header": chdr, "signature_header": b""},
                   "data": wire.encode(cfgpb.CONFIG_ENVELOPE, {"config": config})}
        block = protoutil.new_block(0, b"")
        block["data"]["data"].append(wire.encode(fabric.ENVELOPE, {
            "payload": wire.encode(fabric.PAYLOAD, payload)}))
        return protoutil.seal_block(block)

    def org4_profile(self, enc, to_msp=lambda c: c):
        return enc.OrganizationProfile("Org4MSP", to_msp(self.org4.msp_config()),
                                       anchor_peers=[("peer0.org4.bench", 7051)])

    def org4_datas(self, number, n):
        """`n` txs of block `number` by Org4's client, endorsed by Org1's
        and Org2's peers, each writing its own key org4/{number}/{j}."""
        from fabric_tpu_torch.ledger import rwset as rw
        from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
        from fabric_tpu_torch.protos import fabric, wire

        out = []
        for j in range(n):
            results = serialize_tx_rwset(rw.TxRwSet((rw.NsRwSet(
                "benchcc", (), (rw.KVWrite(f"org4/{number}/{j}", False, b"v"),)),)))
            out.append(wire.encode(fabric.ENVELOPE, self.net.envelope(
                j, client=self.org4_client, results=results)))
        return out

    def config_update(self, config, channel, signers, flip=None):
        """The CONFIG_UPDATE envelope that adds Org4MSP (with its anchor
        peer) to the Application group of `config` and overrides the ACL
        CONFIG_ACL, as configtxlator computes it: the read set pins the
        Application group and every element of it at its version, the write
        set bumps the group and the ACLs value by one and carries Org4's
        group at version 0. Each of `signers` adds a ConfigSignature (the
        one at index `flip` with its signature's last byte flipped); the
        first signs the envelope."""
        from fabric_tpu_torch.channelconfig import configtx as ctx
        from fabric_tpu_torch.channelconfig import encoder
        from fabric_tpu_torch.protos import configtx as cfgpb
        from fabric_tpu_torch.protos import fabric, wire

        app = config["channel_group"]["groups"]["Application"]
        versions = {kind: {n: {"version": e.get("version", 0)} for n, e in app.get(kind, {}).items()}
                    for kind in ("groups", "values", "policies")}
        acls = wire.decode(cfgpb.ACLS, app["values"]["ACLs"]["value"])
        acls["acls"][CONFIG_ACL[0]] = {"policy_ref": CONFIG_ACL[1]}
        write = {kind: {n: dict(v) for n, v in vs.items()} for kind, vs in versions.items()}
        write["groups"]["Org4MSP"] = encoder.new_org_group(self.org4_profile(encoder),
                                                           with_anchors=True)
        write["values"]["ACLs"] = {"version": versions["values"]["ACLs"]["version"] + 1,
                                   "value": wire.encode(cfgpb.ACLS, acls), "mod_policy": "Admins"}
        read = {"version": app.get("version", 0), **versions}
        write.update(version=app.get("version", 0) + 1, mod_policy=app.get("mod_policy", ""))
        update = {"channel_id": channel, "read_set": {"groups": {"Application": read}},
                  "write_set": {"groups": {"Application": write}}}
        cue = {"config_update": wire.encode(cfgpb.CONFIG_UPDATE, update)}
        for signer in signers:
            ctx.sign_config_update(cue, signer)
        if flip is not None:
            sig = cue["signatures"][flip]["signature"]
            cue["signatures"][flip]["signature"] = sig[:-1] + bytes([sig[-1] ^ 0x01])
        return self._envelope(fabric.CONFIG_UPDATE, channel, signers[0],
                              wire.encode(cfgpb.CONFIG_UPDATE_ENVELOPE, cue))

    def config_data(self, validator, update_env, channel):
        """The CONFIG envelope an orderer cuts for `update_env`: the
        ConfigEnvelope that `validator` (a `channelconfig.configtx.Validator`
        on the channel's config) proposes, signed by the orderer."""
        from fabric_tpu_torch.protos import configtx as cfgpb
        from fabric_tpu_torch.protos import fabric, wire

        cenv = validator.propose_config_update(update_env)
        return wire.encode(fabric.ENVELOPE, self._envelope(
            fabric.CONFIG, channel, self.orderer, wire.encode(cfgpb.CONFIG_ENVELOPE, cenv)))

    @staticmethod
    def _envelope(header_type, channel, signer, data):
        from fabric_tpu_torch.protos import fabric, protoutil, wire

        nonce = signer.new_nonce()
        creator = signer.serialize()
        chdr = protoutil.make_channel_header(header_type, channel,
                                             protoutil.compute_tx_id(nonce, creator))
        raw = wire.encode(fabric.PAYLOAD, {"header": {
            "channel_header": wire.encode(fabric.CHANNEL_HEADER, chdr),
            "signature_header": wire.encode(fabric.SIGNATURE_HEADER,
                                            protoutil.make_signature_header(creator, nonce))},
            "data": data})
        return {"payload": raw, "signature": signer.sign(raw)}

    def chain(self, genesis, plain, config_data, config_block, org4_txs, org4_from):
        """Blocks 1, 2, ... after `genesis` as wire bytes, linked, and the
        filter each must get: `plain` gives (datas, codes) of every block
        but the CONFIG block, in order; block `config_block` holds
        `config_data` alone; `org4_txs` txs of Org4's client join the block
        before it (BAD_CREATOR_SIGNATURE: Org4 is unknown) and every block
        from `org4_from` on (VALID)."""
        from fabric_tpu_torch.common.txflags import TxValidationCode as V
        from fabric_tpu_torch.protos import protoutil

        plain = list(plain)
        datas, want = [], []
        for number in range(1, len(plain) + 2):
            if number == config_block:
                datas.append([config_data])
                want.append(bytes([V.VALID]))
                continue
            d, codes = plain[number - 1 if number < config_block else number - 2]
            d, codes = list(d), bytes(codes)
            if number == config_block - 1 or number >= org4_from:
                d += self.org4_datas(number, org4_txs)
                codes += bytes([V.VALID if number >= org4_from else V.BAD_CREATOR_SIGNATURE
                                ]) * org4_txs
            datas.append(d)
            want.append(codes)
        raws = self.net.link(datas, first=1, previous_hash=protoutil.block_header_hash(
            genesis["header"]))
        return raws, want

    @staticmethod
    def signed_data(data: bytes):
        """A transaction envelope's (payload, creator, signature): the
        SignedData of a peer/Propose check, since the port's txbuilder keeps
        no signed proposal."""
        from fabric_tpu_torch.policy.manager import SignedData
        from fabric_tpu_torch.protos import fabric, wire

        env = wire.decode(fabric.ENVELOPE, data)
        payload = wire.decode(fabric.PAYLOAD, env["payload"])
        creator = wire.decode(fabric.SIGNATURE_HEADER,
                              payload["header"]["signature_header"]).get("creator", b"")
        return SignedData(env["payload"], creator, env.get("signature", b""))

    def event_checks(self):
        """The event/Block SignedData: a client of each of Org1-4, Org9's
        user (`Config2Net.stranger`), and Org1's client with a flipped
        signature; the verdicts before the update and after it."""
        from fabric_tpu_torch.policy.manager import SignedData

        out = []
        for signer in self.clients + [self.net.stranger]:
            msg = b"seek newest " + signer.msp_id.encode()
            out.append(SignedData(msg, signer.serialize(), signer.sign(msg)))
        sig = out[0].signature
        out.append(SignedData(out[0].data, out[0].identity, sig[:-1] + bytes([sig[-1] ^ 0x01])))
        return out, [True, True, True, False, False, False], [True, True, True, True, False, False]


class ConfigApplier:
    """The apply_config callback of a Channel, composed as the JAX package
    composes it (the orderer's hot swap, fabric_tpu/orderer/multichannel.py:
    264-280): decode the ConfigEnvelope, `Validator.validate` it against the
    current config and policy tree (the admin signatures through the
    provider), build the new Bundle, and hand its MSP manager to the block
    validator (`block_validator`, set once the Channel exists), which then
    drops its identity caches. Each apply's decode, validate and bundle ms
    go to `ms`."""

    def __init__(self, bundle, provider):
        from fabric_tpu_torch.channelconfig.configtx import Validator

        self.bundle = bundle
        self.provider = provider
        self.configtx = Validator(bundle.channel_id, bundle.config, bundle.policy_manager)
        self.block_validator = None
        self.ms = []

    def __call__(self, config_data: bytes) -> None:
        from fabric_tpu_torch.channelconfig.bundle import Bundle
        from fabric_tpu_torch.channelconfig.configtx import Validator
        from fabric_tpu_torch.protos import configtx as cfgpb
        from fabric_tpu_torch.protos import wire

        t0 = time.perf_counter()
        cenv = wire.decode(cfgpb.CONFIG_ENVELOPE, config_data)
        t1 = time.perf_counter()
        self.configtx.validate(cenv)
        t2 = time.perf_counter()
        bundle = Bundle(self.bundle.channel_id, cenv["config"], self.provider)
        self.bundle = bundle
        self.configtx = Validator(bundle.channel_id, bundle.config, bundle.policy_manager)
        self.block_validator.msp_manager = bundle.msp_manager
        t3 = time.perf_counter()
        self.ms.append({"decode": (t1 - t0) * 1e3, "validate": (t2 - t1) * 1e3,
                        "bundle": (t3 - t2) * 1e3})


def _pool_oracle(lanes):
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey

    return oracle_provider().batch_verify([ECDSAPublicKey(*point) for point, _, _ in lanes],
                                          [s for _, s, _ in lanes], [d for _, _, d in lanes])


def oracle_fill(memo: dict, records, workers=None) -> int:
    """The oracle's verdict of every distinct lane of `records` (a
    recording provider's launches) not yet in `memo`, computed in a pool of
    spawned processes; returns the number computed."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    lanes = list({(k.point, s, d) for r in records
                  for k, s, d in zip(r["keys"], r["sigs"], r["digests"])} - set(memo))
    if not lanes:
        return 0
    workers = workers or min(len(os.sched_getaffinity(0)), 8)
    chunks = [lanes[i::workers] for i in range(workers)]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for chunk, verdicts in zip(chunks, pool.map(_pool_oracle, chunks)):
            memo.update(zip(chunk, verdicts))
    return len(lanes)


def config_phase(torch, np, dev, net, raws, n_txs=CONFIG2_TXS,
                 conflict_block=PIPELINE_CONFLICT_BLOCK, flipped=PIPELINE_FLIPPED,
                 oracle_sample=ORACLE_SAMPLE, config_block=CONFIG_BLOCK,
                 org4_txs=CONFIG_ORG4_TXS, org4_from=CONFIG_ORG4_FROM,
                 acl_threads=ACL_THREADS) -> dict:
    """config_update_config2: a channel whose configuration changes,
    committed on the card. The genesis block from the port's encoder (solo
    orderer org, Org1-3, the sample policies, the default ACLs;
    `ConfigNet.genesis`) is committed
    as the JAX peer's join commits it; then pipeline_config2's signed
    envelopes (`raws`, `net`'s) as blocks 1 to config_block - 1 and, after
    the CONFIG block, as the blocks after it (their flipped signatures and
    conflicts included), with `org4_txs` txs of Org4's client in the block
    before the CONFIG block (refused: Org4 is unknown) and in every block
    from `org4_from` on (VALID). The CONFIG block carries the update that
    adds Org4 and overrides event/Block to Writers, signed by Org1's and
    Org2's admins (MAJORITY of Admins), in the ConfigEnvelope the orderer's
    Validator proposes. The chain commits pipelined (CommitPipeline,
    BatchingProvider over K2, K5) and one block at a time (CUDAProvider,
    K5); filters, commit hashes, .chain and SQLite rows are equal. Beside
    the path: three refused updates, and ACL checks before and after the
    update against the same checks over the oracle. Returns the launches of
    K2, the key combs and K5 on the pipelined chain, for the kernels line."""
    import random
    import shutil
    import threading
    from concurrent.futures import ThreadPoolExecutor as Threads
    from pathlib import Path

    from fabric_tpu_torch.channelconfig.bundle import Bundle, bundle_from_genesis_block
    from fabric_tpu_torch.channelconfig.configtx import ConfigTxError, Validator
    from fabric_tpu_torch.common.txflags import TxValidationCode as V
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.parallel.batcher import BatchingProvider
    from fabric_tpu_torch.peer.aclmgmt import PEER_PROPOSE, ACLError, ACLProvider
    from fabric_tpu_torch.peer.channel import Channel
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.protos import configtx as cfgpb
    from fabric_tpu_torch.protos import fabric, wire
    from fabric_tpu_torch.validation.validator import ChaincodeDefinition, ChaincodeRegistry

    t_phase = time.perf_counter()
    channel_id = CONFIG2_CHANNEL
    cn = ConfigNet(net)
    registry = ChaincodeRegistry([ChaincodeDefinition("benchcc", net.policy)])
    genesis = cn.genesis(channel_id)
    genesis_raw = wire.encode(fabric.BLOCK, genesis)
    # the orderer: its own Validator over the genesis config proposes the
    # ConfigEnvelope of the update
    orderer_bundle = bundle_from_genesis_block(genesis, CUDAProvider(device=dev))
    update_env = cn.config_update(orderer_bundle.config, channel_id, cn.admins[:2])
    config_data = cn.config_data(Validator(channel_id, orderer_bundle.config,
                                           orderer_bundle.policy_manager), update_env, channel_id)
    # the chain: pipeline_config2's block p as block p before the CONFIG
    # block and as block p + 1 after it
    plain = []
    for p, raw in enumerate(raws[1:], start=1):
        d = wire.decode(fabric.BLOCK, raw)["data"]["data"]
        plain.append((d, net.chain_codes(p, len(d), p == conflict_block, channel_id, flipped)))
    blocks_raw, want = cn.chain(genesis, plain, config_data, config_block, org4_txs, org4_from)
    n_blocks = len(blocks_raw)
    n_flipped = sum(len(net.flipped(number, n_txs, channel_id, flipped))
                    for number in range(1, len(raws)))
    setup_s = time.perf_counter() - t_phase
    root = Path(__file__).resolve().parent / "build" / "smoke_config"
    shutil.rmtree(root, ignore_errors=True)
    acl_probe = [cn.signed_data(d) for d in wire.decode(
        fabric.BLOCK, blocks_raw[config_block - 2])["data"]["data"]]
    events, events_before, events_after = cn.event_checks()

    def join(path, provider):
        """A Channel over the genesis bundle with the ConfigApplier, the
        genesis block committed into its ledger."""
        bundle = bundle_from_genesis_block(wire.decode(fabric.BLOCK, genesis_raw), provider)
        if "OrdererMSP" not in {m.msp_id for m in bundle.msp_manager.msps()}:
            raise AssertionError("config_update_config2: the orderer org's MSP is not in the "
                                 "bundle's manager")
        applier = ConfigApplier(bundle, provider)
        ch = Channel(channel_id, str(root / path), bundle.msp_manager, registry, provider,
                     apply_config=applier, device_mvcc=True, device=dev)
        applier.block_validator = ch.validator
        ch.ledger.commit(wire.decode(fabric.BLOCK, genesis_raw))
        return ch, applier

    def acl_checks(applier):
        """peer/Propose on every tx of the block before the CONFIG block and
        event/Block on `events`, through ACLProvider over the applier's
        current bundle, `acl_threads` at a time: the verdicts, the ms, the
        K2 launches, the policy event/Block maps to."""
        acl = ACLProvider(lambda cid: applier.bundle.policy_manager,
                          lambda cid: applier.bundle.application.acls)

        def check(job):
            resource, sd = job
            try:
                acl.check_acl(resource, channel_id, [sd])
                return True
            except ACLError:
                return False

        jobs = [(PEER_PROPOSE, sd) for sd in acl_probe] + [(CONFIG_ACL[0], sd) for sd in events]
        before = p256k.LAUNCHES["p256_verify_bytes"]
        t0 = time.perf_counter()
        with Threads(acl_threads) as pool:
            verdicts = list(pool.map(check, jobs))
        return {"verdicts": verdicts, "ms": (time.perf_counter() - t0) * 1e3,
                "k2_launches": p256k.LAUNCHES["p256_verify_bytes"] - before,
                "event_block_policy": acl.policy_for(CONFIG_ACL[0], channel_id)}

    def oracle_acl(config, memo):
        """The same checks on a bundle of `config` over the oracle."""
        bundle = Bundle(channel_id, config, oracle_provider(memo))
        acl = ACLProvider(lambda cid: bundle.policy_manager, lambda cid: bundle.application.acls)
        out = []
        for resource, sd in [(PEER_PROPOSE, sd) for sd in acl_probe] + [
                (CONFIG_ACL[0], sd) for sd in events]:
            try:
                acl.check_acl(resource, channel_id, [sd])
                out.append(True)
            except ACLError:
                out.append(False)
        return out

    try:
        # --- pipelined: the deliver thread, BatchingProvider, K2 and K5 -------
        recorder = recording_cuda_provider(dev)
        bp = BatchingProvider(recorder)
        ch, applier = join("pipelined", bp)
        n0 = len(recorder.records)
        acl_before = acl_checks(applier)
        n1 = len(recorder.records)
        committed, errors = [], []
        pipe = CommitPipeline(ch, depth=PIPELINE_DEPTH, on_commit=lambda b, f: committed.append(
            (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH])),
            on_error=lambda b, exc: errors.append(exc))
        decoded = [wire.decode(fabric.BLOCK, raw) for raw in blocks_raw]

        def deliver():
            """Every block into the pipeline; after the CONFIG block, a drain:
            without it, stage A of the next blocks deserializes their
            identities against the MSP manager before the update
            (tests/test_torch_config_chain.py pins that in both packages)."""
            try:
                for number, b in enumerate(decoded, start=1):
                    pipe.submit(b)
                    if number == config_block and not pipe.drain(timeout=300):
                        raise AssertionError("the CONFIG block did not commit")
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        for table in (p256k.LAUNCHES, md.LAUNCHES):
            for k in table:
                table[k] = 0
        t0 = time.perf_counter()
        thread = threading.Thread(target=deliver, name="deliver")
        thread.start()
        thread.join()
        drained = pipe.drain(timeout=300)
        wall = time.perf_counter() - t0
        launches = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                    "p256_key_tables": p256k.LAUNCHES["p256_key_tables"],
                    "p256_verify_limbs": p256k.LAUNCHES["p256_verify_limbs"],
                    **k5_launches(md)}
        n2 = len(recorder.records)
        stats, dead = pipe.stage_stats(), pipe.dead
        pipe.stop()
        if errors or not drained or dead:
            raise AssertionError(f"config_update_config2: drained {drained}, dead {dead}, "
                                 f"errors {errors!r}")
        acl_after = acl_checks(applier)
        bp.stop()
        sequence = applier.bundle.sequence
        ch.ledger.close()

        # --- one block at a time over CUDAProvider (K2, K5) ---------------------
        ch_s, applier_s = join("serial", CUDAProvider(device=dev))
        serial_out = []
        t0 = time.perf_counter()
        for raw in blocks_raw:
            b = wire.decode(fabric.BLOCK, raw)
            serial_out.append((ch_s.store_block(b).tobytes(),
                               b["metadata"]["metadata"][fabric.COMMIT_HASH]))
        serial_wall = time.perf_counter() - t0
        ch_s.ledger.close()

        if [f for f, _ in committed] != want or committed != serial_out:
            raise AssertionError("config_update_config2: filters or commit hashes differ from the "
                                 "serial run or the expected codes")
        if sequence != 1 or applier_s.bundle.sequence != 1 or len(applier.ms) != 1:
            raise AssertionError(f"config_update_config2: bundle sequence {sequence}")
        if {o.msp_id for o in applier.bundle.application.orgs} != {
                "Org1MSP", "Org2MSP", "Org3MSP", "Org4MSP"}:
            raise AssertionError("config_update_config2: Org4 is not in the new bundle")
        chain_bytes = {run: (root / run / f"{channel_id}.chain").read_bytes()
                       for run in ("pipelined", "serial")}
        rows = {run: ledger_rows(root / run / f"{channel_id}.state.db")
                for run in ("pipelined", "serial")}
        if chain_bytes["pipelined"] != chain_bytes["serial"] or rows["pipelined"] != rows["serial"]:
            raise AssertionError("config_update_config2: .chain bytes or SQLite rows differ")
        if (launches["mvcc_resolve"] < n_blocks - 1 or launches["mvcc_resolve_global"]
                or launches["p256_verify_bytes"] < 1 or launches["p256_key_tables"] < 1
                or launches["p256_verify_limbs"]
                or launches["p256_verify_bytes"] != n2 - n1):
            raise AssertionError(f"config_update_config2 launches: {launches}")

        # --- refused updates, their lanes through K2 ----------------------------
        refuse_rec = recording_cuda_provider(dev)
        refuse_bundle = bundle_from_genesis_block(wire.decode(fabric.BLOCK, genesis_raw),
                                                  refuse_rec)
        refuse_v = Validator(channel_id, refuse_bundle.config, refuse_bundle.policy_manager)
        flipped_env = cn.config_update(refuse_bundle.config, channel_id, cn.admins[:2], flip=1)
        cases = {"org1_admin_alone": (refuse_v, cn.config_update(
                     refuse_bundle.config, channel_id, cn.admins[:1])),
                 "flipped_admin_signature": (refuse_v, flipped_env),
                 "stale_read_set": (Validator(channel_id, applier.bundle.config,
                                              Bundle(channel_id, applier.bundle.config,
                                                     refuse_rec).policy_manager), update_env)}
        refused = {}
        for name, (v, env) in cases.items():
            try:
                v.propose_config_update(env)
                refused[name] = None
            except ConfigTxError as exc:
                refused[name] = str(exc)
        if not all(refused.values()) or "readset expected" not in refused["stale_read_set"]:
            raise AssertionError(f"config_update_config2: refused updates {refused}")
        bad_sig = wire.decode(cfgpb.CONFIG_UPDATE_ENVELOPE, wire.decode(
            fabric.PAYLOAD, flipped_env["payload"])["data"])["signatures"][1]["signature"]
        bad_lanes = [v for r in refuse_rec.records for s, v in zip(r["sigs"], r["verdicts"])
                     if s == bad_sig]
        if not bad_lanes or any(bad_lanes):
            raise AssertionError("config_update_config2: K2 did not refuse the flipped admin "
                                 "signature")

        # --- the oracle: ACL verdicts, the update's and the checks' lanes -------
        t0 = time.perf_counter()
        memo = {}
        acl_records = recorder.records[n0:n1] + recorder.records[n2:]
        oracle_lanes = oracle_fill(memo, acl_records + refuse_rec.records)
        for r in acl_records + refuse_rec.records:
            if [memo[(k.point, s, d)] for k, s, d in zip(r["keys"], r["sigs"], r["digests"])] != \
                    r["verdicts"]:
                raise AssertionError("config_update_config2: K2 and the oracle disagree on an "
                                     "ACL or refused-update lane")
        oracle_before = oracle_acl(orderer_bundle.config, memo)
        oracle_after = oracle_acl(applier.bundle.config, memo)
        probe_codes = want[config_block - 2]
        org4_first = len(acl_probe) - org4_txs
        propose_before = [c != V.BAD_CREATOR_SIGNATURE for c in probe_codes]
        propose_after = [c != V.BAD_CREATOR_SIGNATURE or i >= org4_first
                         for i, c in enumerate(probe_codes)]
        if (acl_before["verdicts"] != oracle_before or acl_after["verdicts"] != oracle_after
                or acl_before["verdicts"] != propose_before + events_before
                or acl_after["verdicts"] != propose_after + events_after
                or acl_before["event_block_policy"] != "/Channel/Application/Readers"
                or acl_after["event_block_policy"] != CONFIG_ACL[1]):
            raise AssertionError("config_update_config2: ACL verdicts differ from the oracle's or "
                                 "the expected flip")
        admin_points = {applier.bundle.msp_manager.deserialize_identity(
            a.serialize())[0].public_key.point for a in cn.admins}
        if not any(k.point in admin_points for r in recorder.records[n1:n2] for k in r["keys"]):
            raise AssertionError("config_update_config2: no admin lane reached K2")
        k2_held = hold_k2_lanes(torch, p256k, recorder.records[n1:n2], oracle_provider(memo),
                                random.Random(CONFIG_SEED), n_flipped, oracle_sample,
                                "config_update_config2", plain_above=K2_HELD_PADDED_LANES,
                                always=lambda key: key.point in admin_points)
        oracle_s = time.perf_counter() - t0
        emit({"phase": "config_update_config2", "blocks": n_blocks, "config_block": config_block,
              "txs_per_block": n_txs, "org4_txs": org4_txs, "org4_valid_from": org4_from,
              "setup_seconds": setup_s,
              "pipelined": {"seconds": wall, "ms_per_block": wall / n_blocks * 1e3},
              "serial": {"seconds": serial_wall, "ms_per_block": serial_wall / n_blocks * 1e3},
              "stage_stats": stats,
              "apply_config_ms": {"pipelined": applier.ms, "serial": applier_s.ms},
              "bundle_sequence": sequence,
              "acl": {"signed_data": "envelope payload, creator and signature",
                      "checks": len(acl_probe) + len(events),
                      "before": {k: v for k, v in acl_before.items() if k != "verdicts"},
                      "after": {k: v for k, v in acl_after.items() if k != "verdicts"},
                      "allowed_before": sum(acl_before["verdicts"]),
                      "allowed_after": sum(acl_after["verdicts"]), "equal_to_oracle": True},
              "refused_updates": refused, "launches": launches,
              "k2_lanes_held": k2_held, "oracle_lanes": oracle_lanes,
              "oracle_seconds": oracle_s, "flipped_signatures": n_flipped,
              "equal_pipelined_and_serial": True,
              "seconds": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# The BCCSP factory and the host ladder: factory_config2
# ---------------------------------------------------------------------------

# the peer's BCCSP block (sampleconfig/core.yaml's shape); the JAX package's
# TPU slot is the port's CUDA slot
FACTORY_CONFIG = {"Default": "CUDA",
                  "SW": {"Hash": "SHA2", "Security": 256, "ECBackend": "auto",
                         "IdemixBackend": "hostbn"}}
K2_HOLD_CHUNK = 16384  # lanes a host batch of the every-lane hold (one shared-memory block)
DEGRADE_SEAMS = ("hostec.pool", "hostec_np.pool", "hostbn.pool")
SMALL_BATCH_LANES = (2, 31)  # direct batches timed over K2 and over SoftwareProvider
SMALL_BATCH_RUNS = 3


def factory_phase(torch, np, dev, net, k2_records: dict, idemix_sets: dict,
                  n_txs=CONFIG2_TXS, slot_device=None, keep=None) -> dict:
    """factory_config2: the peer's BCCSP built by the factory from the config
    block, as the JAX peer builds it (`FACTORY_CONFIG`): a CUDAProvider for
    the CUDA slot, a SoftwareProvider on the auto walk's tier (hostec_np)
    for SW, a FactoryError for a pinned fastec and for a PKCS#11 library
    that does not exist. Config #2's block and the mask block through
    BlockValidator over each, the filters equal and timed. Every lane K2
    verified or refused on pipeline_config2 and pipeline_config5
    (`k2_records`) held against SoftwareProvider(hostec_np), through a memo
    keyed by lane. A direct batch_verify of 31 lanes is one K2 launch (no
    host route); 2 and 31 lanes timed over K2 and over SoftwareProvider in
    turns; verify() one launch, and its VerifyError comes with no launch.
    Config #3's signatures and the mixed batch (`idemix_sets`) through the
    device route (K4, K3) and the hostbn rung the factory pinned, masks
    equal. No host pool degraded, the pools shut down. Returns the
    phase's launches of K2, the key combs, K3 and K4; a `keep` dict receives
    the lane memo ("memo": (point, signature, digest) -> hostec_np's
    verdict) for serve_phase. `slot_device` places the CUDA slot's provider
    (the card unless a CPU rehearsal passes "cpu")."""
    from pathlib import Path

    from fabric_tpu_torch.common import der, fabobs, p256
    from fabric_tpu_torch.crypto import bccsp, factory, hostec, hostec_np
    from fabric_tpu_torch.idemix import batch as ib
    from fabric_tpu_torch.ops import bn256_kernel as bk
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.ops import pairing_kernel as pkn
    from fabric_tpu_torch.protos import fabric, wire

    t_phase = time.perf_counter()
    for table in (p256k.LAUNCHES, bk.LAUNCHES, pkn.LAUNCHES):
        for k in table:
            table[k] = 0
    try:
        with fabobs.obs_installed() as obs:
            # --- the BCCSP from the config block --------------------------------
            cuda = factory.provider_from_config(FACTORY_CONFIG, device=slot_device)
            sw = factory.provider_from_config({**FACTORY_CONFIG, "Default": "SW"})
            built = {"CUDA": [type(cuda).__name__, str(cuda.device), cuda.describe_backend()],
                     "SW": [type(sw).__name__, sw.describe_backend()],
                     "ec_tier": bccsp.ec_backend_name(),
                     "idemix_tier": bccsp.idemix_backend_name()}
            slot = ["cuda", "cuda"] if slot_device is None else [str(slot_device), "cpu-reference"]
            if built != {"CUDA": ["CUDAProvider", *slot],
                         "SW": ["SoftwareProvider", "sw:hostec_np"], "ec_tier": "hostec_np",
                         "idemix_tier": "hostbn"}:
                raise AssertionError(f"factory_config2: the factory built {built}")
            refused = {}
            no_library = Path(__file__).resolve().parent / "build" / "no-such-libsofthsm2.so"
            for name, cfg in (
                    ("fastec", {**FACTORY_CONFIG, "Default": "SW",
                                "SW": {**FACTORY_CONFIG["SW"], "ECBackend": "fastec"}}),
                    ("pkcs11_missing_library", {"Default": "PKCS11",
                                                "PKCS11": {"Library": str(no_library)}})):
                try:
                    factory.provider_from_config(cfg)
                    refused[name] = None
                except factory.FactoryError as exc:
                    refused[name] = f"{type(exc).__name__}: {exc}"
            if not all(refused.values()) or bccsp.ec_backend_name() != "hostec_np":
                raise AssertionError(f"factory_config2: refused configs {refused}")

            # --- config #2's block and the mask block over each provider ---------
            raw_block = wire.encode(fabric.BLOCK, net.block(n_txs, number=1))
            mask_block, mask_codes = net.mask_block()
            raw_mask = wire.encode(fabric.BLOCK, mask_block)
            blocks = {}
            for label, prov in (("cuda", cuda), ("sw", sw)):
                for name, raw, crl, want in (("config2", raw_block, False, bytes(n_txs)),
                                             ("mask", raw_mask, True, bytes(mask_codes))):
                    ms = []
                    for _ in range(2):  # the first run warms the provider (combs, pool)
                        v = net.validator(prov, with_crl=crl)
                        b = wire.decode(fabric.BLOCK, raw)
                        t0 = time.perf_counter()
                        flags = v.validate(b)
                        ms.append((time.perf_counter() - t0) * 1e3)
                        if flags.tobytes() != want or v.last_sig_backend != prov.describe_backend():
                            raise AssertionError(
                                f"factory_config2: {name} over {v.last_sig_backend}: "
                                f"{list(flags.tobytes())[:20]}")
                    blocks.setdefault(name, {})[label] = {"ms": ms, "split_ms": dict(v.last_ms),
                                                          "backend": v.last_sig_backend}
            pool = hostec_np._pool()
            pool_workers = hostec_np._POOL_PROCS
            worker_torch = (pool.submit(eval, "'torch' in __import__('sys').modules").result()
                            if pool else None)
            if pool is None or worker_torch is not False:
                raise AssertionError(f"factory_config2: hostec_np pool {pool}, a worker imported "
                                     f"torch: {worker_torch}")

            # --- every K2 lane of the pipelined chains against hostec_np ---------
            memo, held = {}, {}
            t0 = time.perf_counter()
            for label, records in k2_records.items():
                todo = {}
                for r in records:
                    for k, sig, d in zip(r["keys"], r["sigs"], r["digests"]):
                        key = (k.point, sig, d)
                        if key not in memo:
                            todo[key] = (k, sig, d)
                todo = list(todo.items())
                t1 = time.perf_counter()
                for off in range(0, len(todo), K2_HOLD_CHUNK):
                    chunk = todo[off: off + K2_HOLD_CHUNK]
                    verdicts = sw.batch_verify([k for _, (k, _, _) in chunk],
                                               [s for _, (_, s, _) in chunk],
                                               [d for _, (_, _, d) in chunk])
                    memo.update(zip((key for key, _ in chunk), verdicts))
                verify_s = time.perf_counter() - t1
                lanes = refused_lanes = 0
                for r in records:
                    want = [memo[(k.point, sig, d)]
                            for k, sig, d in zip(r["keys"], r["sigs"], r["digests"])]
                    if want != r["verdicts"]:
                        raise AssertionError(f"factory_config2: K2 and hostec_np disagree on a "
                                             f"lane of {label}")
                    lanes += len(want)
                    refused_lanes += want.count(False)
                held[label] = {"k2_launches": len(records), "lanes": lanes,
                               "refused": refused_lanes, "verified_on_host": len(todo),
                               "host_seconds": verify_s,
                               "host_lanes_per_s": len(todo) / verify_s if verify_s else None}
            hold_s = time.perf_counter() - t0
            held_lanes = sum(h["lanes"] for h in held.values())
            if keep is not None:
                keep["memo"] = memo

            # --- a small direct batch and verify(): K2, no host route ----------
            rec = k2_records["pipeline_config2"][0]
            order = [i for i, ok in enumerate(rec["verdicts"]) if not ok][:4]
            order += [i for i, ok in enumerate(rec["verdicts"]) if ok][: 31 - len(order)]
            keys = [rec["keys"][i] for i in order]
            sigs = [rec["sigs"][i] for i in order]
            digests = [rec["digests"][i] for i in order]
            want31 = oracle_provider().batch_verify(keys, sigs, digests)
            k2_before = p256k.LAUNCHES["p256_verify_bytes"]
            got31 = cuda.batch_verify(keys, sigs, digests)
            k2_31 = p256k.LAUNCHES["p256_verify_bytes"] - k2_before
            if k2_31 != 1 or got31 != want31:
                raise AssertionError(f"factory_config2: 31 lanes {k2_31} K2 launches; mask "
                                     f"{got31 == want31}")
            # a small batch's round trip over K2 against SoftwareProvider.batch_verify
            # (2 lanes: a config update's authorization), in turns
            small_ms = {}
            for n in SMALL_BATCH_LANES:
                runs = {"cuda": [], "sw": []}
                for _ in range(SMALL_BATCH_RUNS):
                    for label, prov in (("cuda", cuda), ("sw", sw)):
                        t0 = time.perf_counter()
                        got = prov.batch_verify(keys[:n], sigs[:n], digests[:n])
                        runs[label].append((time.perf_counter() - t0) * 1e3)
                        if got != want31[:n]:
                            raise AssertionError(f"factory_config2: {n} lanes over {label}")
                small_ms[str(n)] = runs
            valid = order[len(order) - 1]
            r_, s_ = der.unmarshal_signature(rec["sigs"][valid])
            single = {}
            for name, sig in (("bad_der", b"\x30\x03\x02\x01\x01"),
                              ("high_s", der.marshal_signature(r_, p256.N - s_))):
                k2_before = p256k.LAUNCHES["p256_verify_bytes"]
                try:
                    cuda.verify(rec["keys"][valid], sig, rec["digests"][valid])
                    single[name] = None
                except bccsp.VerifyError as exc:
                    single[name] = str(exc)
                if p256k.LAUNCHES["p256_verify_bytes"] != k2_before:
                    raise AssertionError(f"factory_config2: verify() launched K2 on {name}")
            k2_before = p256k.LAUNCHES["p256_verify_bytes"]
            good = cuda.verify(rec["keys"][valid], rec["sigs"][valid], rec["digests"][valid])
            k2_verify = p256k.LAUNCHES["p256_verify_bytes"] - k2_before
            if not all(single.values()) or not good or k2_verify != 1:
                raise AssertionError(f"factory_config2: verify() {single}, {good}, "
                                     f"{k2_verify} K2 launches")

            # --- Idemix: the device route and the factory's host rung -----------
            idemix = {}
            rung = bccsp.idemix_backend_name()
            for name, args in idemix_sets.items():
                runs = {"device": [], rung: []}
                masks = {}
                for route in ("device", rung, rung, "device"):
                    t0 = time.perf_counter()
                    if route == "device":
                        masks[route] = ib.verify_signatures_batch(*args, device=dev)
                    else:
                        masks[route] = ib.verify_signatures_batch(*args, backend=route)
                    runs[route].append((time.perf_counter() - t0) * 1e3 / len(args[0]))
                if masks["device"] != masks[rung]:
                    raise AssertionError(f"factory_config2: {name} device {masks['device']}, "
                                         f"{rung} {masks[rung]}")
                idemix[name] = {"signatures": len(args[0]), "valid": sum(masks[rung]),
                                "mask_equal": True, "ms_per_signature": runs}
            hostbn_workers = ib._POOL_PROCS if ib._POOL else None

            degrade_counts = {seam: obs.value("fabric_degrade_total", seam=seam)
                              for seam in DEGRADE_SEAMS}
            if any(degrade_counts.values()):
                raise AssertionError(f"factory_config2: degraded {degrade_counts}")
    finally:
        hostec_np.shutdown_pool()
        hostec.shutdown_pool()
        ib.shutdown_pool()
    launches = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                "p256_key_tables": p256k.LAUNCHES["p256_key_tables"],
                "p256_verify_limbs": p256k.LAUNCHES["p256_verify_limbs"],
                "bn256_msm": bk.LAUNCHES["bn256_msm"], "ate2_unity": pkn.LAUNCHES["ate2_unity"]}
    if (not launches["p256_verify_bytes"] or not launches["bn256_msm"]
            or not launches["ate2_unity"] or launches["p256_verify_limbs"]):
        raise AssertionError(f"factory_config2 launches: {launches}")
    emit({"phase": "factory_config2", "config": FACTORY_CONFIG, "built": built,
          "refused_configs": refused, "blocks": blocks,
          "filters_equal": {"config2": "all VALID over both", "mask": mask_codes},
          "hostec_np_pool": {"workers": pool_workers, "start_method": hostec.start_method(),
                             "worker_imports_torch": worker_torch},
          "k2_every_lane": {"lanes": held_lanes, "seconds": hold_s, "by_phase": held},
          "direct_batch": {"lanes": len(got31), "k2_launches": k2_31,
                           "refused_lanes": want31.count(False), "equal_oracle": True,
                           "ms_by_lanes": small_ms},
          "verify": {"k2_launches": k2_verify, "errors": single}, "idemix": idemix,
          "hostbn_pool_workers": hostbn_workers, "degrade_total": degrade_counts,
          "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


SERVE_MAX_PENDING = 16384  # the sidecar's lane budget: four clients' bursts exceed it
SERVE_RT_LANES = (2, 31, 4096, 32768)  # round trips timed through the sidecar and in-process
SERVE_RT_RUNS = 20
SERVE_CLIENTS = (("high", 0), ("normal", 1), ("bulk", 2), ("bulk", 2))  # QoS class a client
SERVE_REQUESTS = 25  # requests a client
SERVE_REQUEST_LANES = (256, 4096)
SERVE_NO_KEY = (3000, 10, 5)  # lanes, NO_KEY lanes, lanes under an undecodable key
SERVE_KILL_LANES = 32768
SERVE_RESTART_REQUESTS = 40
SERVE_RESTART_LANES = (100, 700, 3000, 9000, 20000)  # a request's lanes behind the router
SERVE_DAEMON_WAIT_S = 120.0


def serve_phase(torch, np, dev, net, raws, memo: dict, pipeline_ref: dict,
                n_txs=CONFIG2_TXS, rt_lanes=SERVE_RT_LANES, rt_runs=SERVE_RT_RUNS,
                requests=SERVE_REQUESTS, request_lanes=SERVE_REQUEST_LANES,
                no_key=SERVE_NO_KEY, kill_lanes=SERVE_KILL_LANES,
                restart_requests=SERVE_RESTART_REQUESTS, restart_lanes=SERVE_RESTART_LANES,
                daemon_warm="verify", slot_device=None) -> dict:
    """serve_config2: config #2 verified through the serve sidecar
    (`fabric_tpu_torch.serve`): an in-process SidecarServer on the card's
    CUDAProvider (warmed on the `verify` ladder: K1 at every bucket) behind
    the factory's SERVE rung. Config #2's block and the mask block through
    BlockValidator, filters equal to the in-process CUDAProvider's; the
    pipelined chain through Channel/CommitPipeline, filters and commit
    hashes equal to pipeline_config2's; round trips against the in-process
    provider; four clients of three QoS classes against a 16,384-lane
    budget; NO_KEY and undecodable-key lanes; a daemon started with
    `python -m fabric_tpu_torch.serve`, SIGKILLed mid-batch, the batch
    rescued on this process's CUDAProvider; a rolling restart of one of two
    sidecars behind a SidecarRouter. Every mask against `memo`, factory_
    config2's hostec_np verdicts. Returns the launches of K1, K2 and the key
    combs by the sidecars and by the rescue, and K5's, for the kernels line.
    `slot_device` places the providers (the card unless a CPU rehearsal
    passes "cpu")."""
    import os
    import random
    import shutil
    import signal
    import statistics
    import tempfile
    import threading
    from pathlib import Path

    from fabric_tpu_torch.common import fabobs
    from fabric_tpu_torch.common.retry import RetryPolicy
    from fabric_tpu_torch.crypto import factory
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.peer.channel import Channel
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.protos import fabric, wire
    from fabric_tpu_torch.serve import protocol as proto
    from fabric_tpu_torch.serve.client import (
        SidecarClient,
        SidecarProvider,
        SidecarUnavailable,
        encode_lanes,
    )
    from fabric_tpu_torch.serve.router import SidecarRouter
    from fabric_tpu_torch.serve.server import SidecarServer
    from fabric_tpu_torch.validation.validator import ChaincodeDefinition, ChaincodeRegistry

    t_phase = time.perf_counter()
    rng = random.Random(CONFIG2_SEED + 14)
    keys_by_point = {}
    lanes = []
    for (point, sig, digest), ok in memo.items():
        key = keys_by_point.setdefault(point, ECDSAPublicKey(*point))
        lanes.append((key, sig, digest, ok))

    def draw(n):
        """n memo lanes (tiled past the memo) and their hostec_np verdicts."""
        picked = [lanes[i % len(lanes)] for i in rng.sample(range(len(lanes)), min(n, len(lanes)))]
        picked += [lanes[rng.randrange(len(lanes))] for _ in range(n - len(picked))]
        return ([k for k, _, _, _ in picked], [s for _, s, _, _ in picked],
                [d for _, _, d, _ in picked], [ok for _, _, _, ok in picked])

    def device_provider():
        return factory.provider_from_config({"Default": "CUDA"}, device=slot_device)

    def launches_of(provider):
        return dict(provider.launches)

    def moved(after, before):
        return {k: after[k] - before[k] for k in after}

    def spread(ms):
        q = statistics.quantiles(ms, n=4) if len(ms) > 1 else [ms[0]] * 3
        return {"median": statistics.median(ms), "q1": q[0], "q3": q[2], "min": min(ms),
                "max": max(ms)}

    root = Path(tempfile.mkdtemp(prefix="fts"))  # AF_UNIX paths stay short
    ledgers = Path(__file__).resolve().parent / "build" / "smoke_ledgers"
    shutil.rmtree(ledgers, ignore_errors=True)
    servers, clients, daemon = [], [], None
    for table in (p256k.LAUNCHES, md.LAUNCHES):
        for k in table:
            table[k] = 0
    local = device_provider()  # this process's own provider: comparisons and the rescue
    try:
        with fabobs.obs_installed() as obs:
            # --- 1. an in-process sidecar, warmed on the verify ladder -----------
            t0 = time.perf_counter()
            server = SidecarServer(str(root / "a.sock"), engine="device", device=slot_device,
                                   warm_ladder="verify", max_pending_lanes=SERVE_MAX_PENDING)
            servers.append(server)
            warm = server.warm()
            server.start()
            start_s = time.perf_counter() - t0
            unwarmed = server.registry.bucket_for(kill_lanes)
            try:
                server.registry.program_for(kill_lanes)
                raise AssertionError(f"serve_config2: bucket {unwarmed} was never warmed, yet "
                                     "the registry returned a program")
            except KeyError:
                pass
            cfg = {"Default": "SERVE", "SERVE": {"Address": server.address}}
            serve = factory.provider_from_config(cfg)
            clients.append(serve)

            # --- 2. config #2's block and the mask block over the SERVE rung -----
            raw_block = wire.encode(fabric.BLOCK, net.block(n_txs, number=1))
            mask_block, mask_codes = net.mask_block()
            raw_mask = wire.encode(fabric.BLOCK, mask_block)
            blocks = {}
            for name, raw, crl, want in (("config2", raw_block, False, bytes(n_txs)),
                                         ("mask", raw_mask, True, bytes(mask_codes))):
                flags = {}
                for label, prov in (("cuda", local), ("serve", serve)):
                    ms = []
                    before_local, before_server = launches_of(local), launches_of(server.provider)
                    for _ in range(2):  # the first run warms the identities and combs
                        v = net.validator(prov, with_crl=crl)
                        b = wire.decode(fabric.BLOCK, raw)
                        t1 = time.perf_counter()
                        flags[label] = v.validate(b).tobytes()
                        ms.append((time.perf_counter() - t1) * 1e3)
                        if flags[label] != want or v.last_sig_backend != prov.describe_backend():
                            raise AssertionError(f"serve_config2: {name} over {label}: "
                                                 f"{list(flags[label])[:20]}")
                    blocks.setdefault(name, {})[label] = {
                        "ms": ms, "split_ms": dict(v.last_ms),
                        "local_launches": moved(launches_of(local), before_local),
                        "server_launches": moved(launches_of(server.provider), before_server)}
                k2 = "p256_verify_bytes"
                if (blocks[name]["serve"]["local_launches"][k2]
                        or not blocks[name]["serve"]["server_launches"][k2]
                        or blocks[name]["cuda"]["server_launches"][k2]):
                    raise AssertionError(f"serve_config2: {name} launches {blocks[name]}")

            # --- 3. the pipelined chain over the SERVE rung ----------------------
            registry = ChaincodeRegistry([ChaincodeDefinition("benchcc", net.policy)])
            ch = Channel(CONFIG2_CHANNEL, str(ledgers / "serve"), net.managers[False], registry,
                         serve, device_mvcc=True, device=dev)
            committed = []
            pipe = CommitPipeline(ch, depth=PIPELINE_DEPTH, on_commit=lambda b, f: committed.append(
                (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH])))
            k5_before = md.LAUNCHES["mvcc_resolve"]
            t1 = time.perf_counter()
            for raw in raws:
                pipe.submit(wire.decode(fabric.BLOCK, raw))
            drained = pipe.drain(timeout=300)
            chain_s = time.perf_counter() - t1
            dead, last_error = pipe.dead, pipe.last_error
            pipe.stop()
            ch.ledger.close()
            k5 = md.LAUNCHES["mvcc_resolve"] - k5_before
            if not drained or dead or last_error is not None or committed != pipeline_ref["committed"]:
                raise AssertionError(f"serve_config2: the chain over the sidecar: drained {drained}, "
                                     f"dead {dead}, {last_error!r}, filters and hashes equal "
                                     f"{committed == pipeline_ref['committed']}")
            chain = {"blocks": len(raws), "ms_per_block": chain_s / len(raws) * 1e3,
                     "pipeline_config2_ms_per_block": pipeline_ref["ms_per_block"],
                     "k5_launches": k5, "equal_to_pipeline_config2": True}

            # --- 4. round trips: the sidecar against the in-process provider ------
            rt = {}
            for n in rt_lanes:
                k, s, d, want = draw(n)
                runs = {"serve": [], "cuda": []}
                for _ in range(rt_runs):
                    for label, prov in (("serve", serve), ("cuda", local)):
                        t1 = time.perf_counter()
                        got = prov.batch_verify(k, s, d)
                        runs[label].append((time.perf_counter() - t1) * 1e3)
                        if got != want:
                            raise AssertionError(f"serve_config2: {n} lanes over {label}")
                rt[str(n)] = {label: spread(v) for label, v in runs.items()}
                rt[str(n)]["added_ms"] = rt[str(n)]["serve"]["median"] - rt[str(n)]["cuda"]["median"]

            # --- 5. four clients, three classes, one lane budget -------------------
            patient = RetryPolicy(base_s=0.005, multiplier=2.0, cap_s=0.1, deadline_s=120.0,
                                  max_attempts=2000)
            load = [SidecarProvider(server.address, qos_class=cls, channel=f"{name}{i}",
                                    busy_policy=patient, fallback=local)
                    for i, (name, cls) in enumerate(SERVE_CLIENTS)]
            clients.extend(load)
            work = [[draw(rng.randint(*request_lanes)) for _ in range(requests)] for _ in load]
            before_server, served_before = launches_of(server.provider), server.stats.summary()
            errors = []

            def drive(client, batches):
                try:
                    resolvers = [client.batch_verify_async(k, s, d) for k, s, d, _ in batches]
                    for r, (_, _, _, want) in zip(resolvers, batches):
                        if r() != want:
                            errors.append(f"a {client.channel} mask differs from the memo")
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    errors.append(repr(exc))

            threads = [threading.Thread(target=drive, args=(c, w), name=f"load-{c.channel}")
                       for c, w in zip(load, work)]
            t1 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            load_s = time.perf_counter() - t1
            if errors or any(t.is_alive() for t in threads) or any(c.degraded for c in load):
                raise AssertionError(f"serve_config2: the four clients: {errors[:3]}, degraded "
                                     f"{[c.degraded for c in load]}")
            summary = server.stats.summary()
            n_requests = len(load) * requests
            coalescing = {
                "requests": n_requests,
                "lanes": sum(len(b[0]) for w in work for b in w),
                "k2_launches": moved(launches_of(server.provider), before_server)["p256_verify_bytes"],
                "batcher_launches": server.batcher.launches,
                "requests_per_s": n_requests / load_s, "seconds": load_s,
                "client_busy_rejects": {c.channel: c.busy_rejects for c in load},
                "busy_by_class": {cls: v["busy"] for cls, v in summary["per_class"].items()},
                "served_by_class": {cls: v["served"] - served_before["per_class"].get(
                    cls, {}).get("served", 0) for cls, v in summary["per_class"].items()},
                "latency": summary["request_latency"],
                "latency_by_class": {cls: v["latency"] for cls, v in summary["per_class"].items()},
                "qos_balance": server.qos.balance()}
            if coalescing["qos_balance"]["leaked"]:
                raise AssertionError(f"serve_config2: QoS lanes leaked {coalescing['qos_balance']}")

            # --- 6. lanes with no usable key --------------------------------------
            n_lanes, n_none, n_bad = no_key
            k, s, d, want = draw(n_lanes)
            payload = encode_lanes(k, s, d, deadline_ms=0)
            table, wire_lanes, _, _, _ = proto.decode_verify_request(payload, proto.PROTOCOL_VERSION)
            table += [b"\x04" + b"\x01" * 64, b"\x02" + b"\x07" * 32]  # off the curve, compressed
            for j, i in enumerate(rng.sample(range(n_lanes), n_none + n_bad)):
                _, sig, digest = wire_lanes[i]
                wire_lanes[i] = (proto.NO_KEY if j < n_none else len(table) - 1 - j % 2, sig, digest)
                want[i] = False
            raw_client = SidecarClient(server.address)
            try:
                status, _, got, message = proto.decode_verify_response(raw_client.request(
                    proto.OP_VERIFY, proto.encode_verify_request(
                        table, wire_lanes, qos_class=proto.DEFAULT_QOS, channel="", deadline_ms=0),
                    timeout_s=120.0))
            finally:
                raw_client.close()
            if status != proto.ST_OK or got != want:
                raise AssertionError(f"serve_config2: the NO_KEY request: {status} {message}")

            # --- 7. a daemon killed mid-batch, the batch rescued here -------------
            repo = Path(__file__).resolve().parent
            daemon_sock = str(root / "daemon.sock")
            cmd = [sys.executable, "-m", "fabric_tpu_torch.serve", "--address", daemon_sock,
                   "--engine", "device", "--warm", daemon_warm]
            if slot_device is not None:
                cmd += ["--device", str(slot_device)]
            env = dict(os.environ, PYTHONPATH=str(repo) + os.pathsep + os.environ.get(
                "PYTHONPATH", ""))
            log_path = root / "daemon.log"
            ready_lines = []
            with open(log_path, "w") as log:
                t1 = time.perf_counter()
                daemon = subprocess.Popen(cmd, cwd=str(repo), env=env, stdout=subprocess.PIPE,
                                          stderr=log, text=True)

                def read_ready():
                    for line in daemon.stdout:
                        if line.startswith("SERVE_READY "):
                            ready_lines.append(line)
                            return

                reader = threading.Thread(target=read_ready, daemon=True)
                reader.start()
                first_ping_s = None
                while time.perf_counter() - t1 < SERVE_DAEMON_WAIT_S and daemon.poll() is None:
                    pinger = SidecarClient(daemon_sock, connect_timeout_s=2.0)  # a fresh dial
                    try:
                        if pinger.ping(timeout_s=2.0):
                            first_ping_s = time.perf_counter() - t1
                            break
                    except SidecarUnavailable:  # not listening yet
                        time.sleep(0.1)
                    finally:
                        pinger.close()
                reader.join(timeout=10)
            if first_ping_s is None or not ready_lines:
                raise AssertionError(f"serve_config2: the daemon did not answer a PING in "
                                     f"{SERVE_DAEMON_WAIT_S} s: {log_path.read_text()[-2000:]}")
            daemon_warm_report = json.loads(ready_lines[0].split(" ", 1)[1])["warm"]
            victim = SidecarProvider(daemon_sock, fallback=local)
            clients.append(victim)
            k, s, d, want = draw(kill_lanes)
            before_local = launches_of(local)
            degrade_before = obs.value("fabric_degrade_total", seam="serve.client")
            resolver = victim.batch_verify_async(k, s, d)
            daemon.send_signal(signal.SIGKILL)
            daemon.wait(timeout=60)
            got = resolver()
            rescue = moved(launches_of(local), before_local)
            degrade = obs.value("fabric_degrade_total", seam="serve.client") - degrade_before
            if (got != want or not victim.degraded or victim.rescues != 1 or degrade != 1
                    or not rescue["p256_verify_bytes"]):
                raise AssertionError(f"serve_config2: the kill's rescue: mask {got == want}, "
                                     f"degraded {victim.degraded}, rescues {victim.rescues}, "
                                     f"degrade_total {degrade}, launches {rescue}")
            kill = {"lanes": kill_lanes, "seconds_to_first_ping": first_ping_s,
                    "daemon_warm": daemon_warm_report, "daemon_exit": daemon.returncode,
                    "rescue_launches": rescue, "degrade_total": degrade}

            # --- 8. a rolling restart behind the router ---------------------------
            fleet = [SidecarServer(str(root / f"r{i}.sock"), engine="device", device=slot_device,
                                   max_pending_lanes=SERVE_MAX_PENDING) for i in range(2)]
            for srv in fleet:
                srv.warm()
                srv.start()
            servers.extend(fleet)
            router = SidecarRouter([srv.address for srv in fleet], fallback=local)
            clients.append(router)
            work = [draw(rng.choice(restart_lanes)) for _ in range(restart_requests)]
            # the restarted sidecar is the one the first request prefers, so
            # it serves before its drain; the other serves while it is down
            old = next(srv for srv in fleet
                       if srv.address == router._order(len(work[0][0]))[0].address)
            other = next(srv for srv in fleet if srv is not old)
            done, errors = [], []

            def run_fleet():
                try:
                    for i, (k, s, d, want) in enumerate(work):
                        if router.batch_verify(k, s, d) != want:
                            errors.append(f"request {i}'s mask differs from the memo")
                        done.append(i)
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    errors.append(repr(exc))

            def wait_done(n):
                deadline = time.perf_counter() + 300
                while len(done) < n and worker.is_alive() and time.perf_counter() < deadline:
                    time.sleep(0.005)

            before_local = launches_of(local)
            worker = threading.Thread(target=run_fleet, name="fleet")
            worker.start()
            wait_done(restart_requests // 4)
            drained = old.drain()
            old.stop()
            wait_done(len(done) + 1)  # a request served while the address is dark
            new = SidecarServer(old.address, engine="device", device=slot_device,
                                max_pending_lanes=SERVE_MAX_PENDING)
            new.warm()
            new.start()
            servers.append(new)
            worker.join(timeout=300)
            served = {"drained": old.stats.summary()["requests"],
                      "restarted": new.stats.summary()["requests"],
                      "other": other.stats.summary()["requests"]}
            if (errors or worker.is_alive() or len(done) != restart_requests or router.degraded
                    or router.rescues or moved(launches_of(local), before_local)["p256_verify_bytes"]
                    or not served["other"] or not served["drained"]):
                raise AssertionError(f"serve_config2: the rolling restart: {errors[:3]}, done "
                                     f"{len(done)}, rescues {router.rescues}, served {served}")
            restart = {"requests": restart_requests, "drained_in_time": drained,
                       "served": served, "hedges": router.hedges, "hedge_wins": router.hedge_wins,
                       "slow_evictions": router.slow_evictions,
                       "busy_rejects": router.busy_rejects,
                       "endpoints": router.describe()["endpoints"]}
            degraded = [type(c).__name__ for c in clients if c is not victim and c.degraded]
            if degraded:
                raise AssertionError(f"serve_config2: degraded clients {degraded}")
            server_launches = {}
            for srv in servers:
                for name, n in launches_of(srv.provider).items():
                    server_launches[name] = server_launches.get(name, 0) + n
            totals = dict(p256k.LAUNCHES)
    finally:
        for c in clients:
            c.stop()
        for srv in servers:
            srv.stop()
        if daemon is not None:
            if daemon.poll() is None:
                daemon.kill()
                daemon.wait(timeout=60)
            daemon.stdout.close()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ledgers, ignore_errors=True)
    # the sidecars' K1 are the registry's warm launches: K1 is called
    # directly there, never through a provider
    server_launches["p256_verify_limbs"] = (totals["p256_verify_limbs"]
                                            - launches_of(local)["p256_verify_limbs"])
    launches = {"server": server_launches, "rescue": kill["rescue_launches"],
                "in_process": launches_of(local), "mvcc_resolve": k5}
    # the sidecars' K1 is the warm ladder alone: requests share their keys'
    # objects, so a coalesced launch keeps the bytes route
    if (not server_launches["p256_verify_bytes"] or not server_launches["p256_key_tables"]
            or server_launches["p256_verify_limbs"] != len(warm.get("per_bucket", {}))
            or totals["p256_verify_bytes"] != server_launches["p256_verify_bytes"]
            + launches["in_process"]["p256_verify_bytes"] or not k5):
        raise AssertionError(f"serve_config2 launches: {launches}, totals {totals}")
    emit({"phase": "serve_config2", "warm": warm, "start_seconds": start_s,
          "unwarmed_bucket": unwarmed, "blocks": blocks,
          "filters_equal": {"config2": "all VALID over both", "mask": mask_codes},
          "chain": chain, "round_trip_ms": rt, "coalescing": coalescing,
          "no_key": {"lanes": n_lanes, "no_key": n_none, "undecodable": n_bad,
                     "mask_equal": True},
          "kill": kill, "rolling_restart": restart, "launches": launches,
          "launch_totals": totals, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# P-256 (K1, K2): the edge lanes of the kernel-vs-plain phase
# ---------------------------------------------------------------------------


def p256_lane_from_scalars(p256, u1: int, u2: int, q: int, tag: bytes):
    """A lane that verifies, built backwards from chosen u1 = e/s, u2 = r/s
    and key Q = q G: R = (u1 + u2 q) G, r = x(R) mod n, s = r / u2, e = u1 s.
    Returns (point, digest, r, s, True)."""
    n = p256.N
    r = p256.scalar_mult((u1 + u2 * q) % n, p256.GENERATOR)[0] % n
    w = u2 * pow(r, -1, n) % n
    s = pow(w, -1, n)
    e = u1 * s % n
    assert p256.verify_digest(p256.scalar_mult(q, p256.GENERATOR), e.to_bytes(32, "big"), r, s), tag
    return p256.scalar_mult(q, p256.GENERATOR), e.to_bytes(32, "big"), r, s, True


def p256_thread_scalar(u1: int, u2: int, q: int, j: int, n: int) -> int:
    """The scalar of K2's thread j's partial sum (windows j, j + 8, ...):
    its digits of u1 plus q times its digits of u2."""
    mask = sum(15 << (4 * w) for w in range(j, 64, 8))
    return ((u1 & mask) + q * (u2 & mask)) % n


def p256_crafted_lanes(p256, privs):
    """(name, point, digest, r, s, valid_in) edge lanes for K1 and K2: the
    complete formulas' cases (Q = G, u1 = u2, u1 G = -u2 Q), e >= n, the
    r + n candidate, high-S, s = 0, r = 0, r = n, an off-curve key whose
    False comes from the arithmetic, valid_in false; zero digits in whole
    windows of u1 and of u2 (identity entries of both combs); and keys
    chosen so that K2's partial sums of threads 0 and 4 cancel (P + (-P))
    or are equal (P + P) in its shuffle tree."""
    keys = [p256.scalar_mult(d, p256.GENERATOR) for d in privs[:8]]
    g = p256.GENERATOR
    n = p256.N
    d0 = hashlib.sha256(b"edge").digest()
    r1, s1 = p256.sign_digest(1, d0, k=7)  # Q = G
    k_eq = 0x1234567
    r_eq = p256.scalar_mult(k_eq, g)[0] % n
    d_eq = r_eq.to_bytes(32, "big")  # e == r: u1 == u2
    r2, s2 = p256.sign_digest(privs[1], d_eq, k=k_eq)
    d_zero = bytes(32)
    r3, s3 = p256.sign_digest(privs[2], d_zero, k=99)
    d_big = b"\xff" * 32  # e >= n
    r4, s4 = p256.sign_digest(privs[3], d_big, k=101)
    r5, s5 = p256.sign_digest(1, d_eq, k=k_eq)  # Q = G and u1 == u2: doubling in the ladder
    pmn = p256.P - n
    u1 = int.from_bytes(hashlib.sha256(b"u1").digest(), "big") % n
    u2 = int.from_bytes(hashlib.sha256(b"u2").digest(), "big") % n
    # q with thread 0's and thread 4's partial sums opposite, then equal
    a0, a4 = (p256_thread_scalar(u1, 0, 0, j, n) for j in (0, 4))
    b0, b4 = (p256_thread_scalar(0, u2, 1, j, n) for j in (0, 4))
    q_cancel = -(a0 + a4) * pow(b0 + b4, -1, n) % n
    q_equal = -(a0 - a4) * pow(b0 - b4, -1, n) % n
    return [
        ("Q=G", g, d0, r1, s1, True),
        ("e==r", keys[1], d_eq, r2, s2, True),
        ("zero-digest", keys[2], d_zero, r3, s3, True),
        ("e>=n", keys[3], d_big, r4, s4, True),
        ("Q=G,e==r", g, d_eq, r5, s5, True),
        # u1*G = -u2*Q with Q = G: e = n - r, any s; the sum is infinity
        ("u1G=-u2Q", g, (n - 12345).to_bytes(32, "big"), 12345, 777, True),
        ("r<p-n", keys[4], d0, 5, 1234567, True),  # the r+n candidate
        ("r=p-n-1", keys[4], d0, pmn - 1, 4321, True),
        ("r=p-n", keys[4], d0, pmn, 4321, True),
        ("high-S", keys[5], d0, r1, n - s1, True),  # high-S reaching the kernel
        ("s=0", keys[5], d0, r1, 0, True),
        ("r=0", keys[5], d0, 0, s1, True),
        ("r=n", keys[5], d0, n, s1, True),
        ("off-curve", (keys[6][0], (keys[6][1] + 1) % p256.P), d0, r1, s1, True),
        ("valid-masked", keys[6], d0, r1, s1, False),
        ("u1-zero-windows", *p256_lane_from_scalars(p256, 5, u2, privs[7], b"u1")),
        ("u2-zero-windows", *p256_lane_from_scalars(p256, u1, 7 << 160, privs[7], b"u2")),
        ("tree-cancel", *p256_lane_from_scalars(p256, u1, u2, q_cancel, b"cancel")),
        ("tree-equal", *p256_lane_from_scalars(p256, u1, u2, q_equal, b"equal")),
    ]


def ptxas_by_function(report: str) -> dict:
    """`-Xptxas -v` output grouped by function: for each entry (and
    non-inlined) function, its stack/spill line and its registers/shared
    memory line."""
    out, name = {}, None
    for ln in report.splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", ln)
             or re.search(r"Function properties for (\S+)", ln))
        if m:
            name = m.group(1)
            out.setdefault(name, [])
        elif name and ("stack frame" in ln or "Used" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return out


def key_table_probe(torch, np, pk, kx, ky, reps: int = 20) -> dict:
    """The key-comb kernel's time and its split. Each block writes the SM
    clock (clock64) at its start, at the end of its doubling chain, at the
    end of its fill and around the four steps of doubling 128
    (`p256_kernel.key_tables_stamped`); the kernel's
    time is the mean of `reps` launches between CUDA events, split in the
    ratio of the slowest block's stamps. Reports the chain's cycles and a
    doubling's (the chain over its 255 doublings), the steps of doubling
    128, the fill left after the chain, and the clock the stamps imply."""
    tables, stamps = pk.key_tables_stamped(kx, ky)
    again = pk.key_tables(kx, ky)
    torch.cuda.synchronize()
    if not torch.equal(tables, again):
        raise AssertionError("p256_key_tables: the stamped launch wrote other words")
    st = stamps.cpu().numpy().astype(np.int64)
    chain, tail, total = st[:, 1] - st[:, 0], st[:, 2] - st[:, 1], st[:, 2] - st[:, 0]
    slow = int(np.argmax(total))
    pk.key_tables(kx, ky)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        pk.key_tables(kx, ky)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    share = float(chain[slow]) / float(total[slow])
    steps = np.diff(st[slow, 3:8])
    return {"keys": int(kx.shape[1]), "ms": ms, "chain_ms": ms * share,
            "doubling_128_cycles": {"level1": int(steps[0]), "abcd": int(steps[1]),
                                    "level2": int(steps[2]), "point": int(steps[3])},
            "fill_after_chain_ms": ms * (1.0 - share),
            "chain_cycles": int(chain[slow]), "fill_after_chain_cycles": int(tail[slow]),
            "doubling_cycles": float(chain[slow]) / 255.0,
            "block_cycles": [int(total.min()), int(total.max())],
            "implied_sm_mhz": float(total[slow]) / (ms * 1e3)}


def p256_privs(p256):
    """The P-256 phases' 64 private keys."""
    return [(k * 0x9E3779B97F4A7C15 + SEED_PRIV) % (p256.N - 1) + 1 for k in range(64)]


def p256_pool(p256, der, ECDSAPublicKey, keys, privs, nkeys: int, nrows: int, tag: str):
    """(key, DER signature, digest) rows signed with keys[0:nkeys]; rows
    with i % 16 >= 8 corrupted: a flipped digest, the wrong key, s + 1, the
    high S, bad DER, r = 0, r = n, a key off the curve."""
    off_curve = ECDSAPublicKey(keys[0].x, (keys[0].y + 1) % p256.P)
    rows = []
    for i in range(nrows):
        kidx = i % nkeys
        key = keys[kidx]
        digest = hashlib.sha256(f"{tag} {i}".encode()).digest()
        nonce = (i * 0xD6E8FEB86659FD93 + SEED_NONCE) % (p256.N - 1) + 1
        r, s = p256.sign_digest(privs[kidx], digest, k=nonce)
        kind = i % 16
        sig = None
        if kind == 8:
            digest = bytes([digest[0] ^ 1]) + digest[1:]
        elif kind == 9:
            key = keys[(kidx + 1) % nkeys]
        elif kind == 10:
            s = s + 1
        elif kind == 11:
            s = p256.N - s
        elif kind == 12:
            sig = der.marshal_signature(r, s)[:-3]
        elif kind == 13:
            r = 0
        elif kind == 14:
            r = p256.N
        elif kind == 15:
            key = off_curve
        if sig is None:
            sig = der.marshal_signature(r, s)
        rows.append((key, sig, digest))
    return rows


def p256_bounds(work, nbytes: int, imad_rate: float) -> dict:
    """bound_ms (the least work known), bound_ms_kernel (the kernel's own),
    bound_ms_replaced (the replaced one-thread-a-lane kernel's), each the
    larger of its IMAD slots over the card's rate and the bytes over the
    memory rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    for key, slots in (("bound_ms", work["least"]), ("bound_ms_kernel", work["kernel"]),
                       ("bound_ms_replaced", work.get("replaced"))):
        if slots is not None:
            out[key] = max(slots / imad_rate * 1e3, bytes_ms)
    out["bound_by"] = "operations" if work["least"] / imad_rate * 1e3 >= bytes_ms else "bytes"
    return out


def der_parsed(native, before: int, batches: int) -> str:
    """"native" when the provider's DER parse ran `batches` times through
    the native library since `before` (its fn_batch_der_parse count);
    anything else raises."""
    ran = native.CALLS["fn_batch_der_parse"] - before
    if ran != batches:
        raise AssertionError(f"the native DER parse ran {ran} times for {batches} batches")
    return "native"


def p256_phases(torch, np, dev, imad_rate, keep=None):
    """Phases 1-5 (the CUDAProvider and K1, K2 and the table kernel);
    returns their entries of the kernels line, K2's and the table kernel's
    times at the block's shape, and the DER signatures the native phase
    parses (the headline's and the crafted lanes'). A `keep` dict receives
    the headline's and the limb route's rows with their oracle masks
    ("headline", "limb") for mesh_sharded_phase."""
    from fabric_tpu_torch.common import der, p256
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey, VerifyError, parse_and_precheck
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider, _bucket as bucket
    from fabric_tpu_torch.crypto.cuda_provider import be_bytes_to_limbs
    from fabric_tpu_torch.ops import p256_kernel as pk
    from fabric_tpu_torch.utils import native

    # --- inputs ----------------------------------------------------------
    t0 = time.perf_counter()
    privs = p256_privs(p256)
    keys = [ECDSAPublicKey(*p256.scalar_mult(d, p256.GENERATOR)) for d in privs]

    def oracle(key, sig, digest) -> bool:
        try:
            r, s = parse_and_precheck(sig)
        except VerifyError:
            return False
        return p256.verify_digest(key.point, digest, r, s)

    def pool(nkeys: int, nrows: int, tag: str):
        rows = p256_pool(p256, der, ECDSAPublicKey, keys, privs, nkeys, nrows, tag)
        return rows, [oracle(*row) for row in rows]

    pool8, want8 = pool(8, 1024, "headline")
    pool3, want3 = pool(3, 300, "block")
    pool64, want64 = pool(64, 192, "limb")
    pool32, want32 = pool(31, 248, "keys32")  # with the off-curve key, 32 columns
    emit({"phase": "inputs", "unique_rows": len(pool8) + len(pool3) + len(pool64) + len(pool32),
          "seconds": time.perf_counter() - t0})

    def tile(rows, want, n):
        return [rows[i % len(rows)] for i in range(n)], [want[i % len(want)] for i in range(n)]

    # --- phase 1: kernel vs plain version, 64 lanes ------------------------
    lanes = []  # (point, digest, r, s, valid_in)
    for key, sig, digest in pool8[:40]:
        try:
            r, s = parse_and_precheck(sig)
            valid = 1 <= r < p256.N and 1 <= s < p256.N and p256.is_on_curve(key.point)
        except VerifyError:
            r, s, valid = 0, 0, False
        lanes.append((key.point, digest, r, s, valid))
    crafted = [lane[1:] for lane in p256_crafted_lanes(p256, privs)]
    lanes += crafted
    while len(lanes) < 64:
        lanes.append(lanes[len(lanes) % 40])
    want1 = [bool(v) and p256.verify_digest(pt, d, r, s) for pt, d, r, s, v in lanes]
    points = sorted({ln[0] for ln in lanes})
    col = {pt: i for i, pt in enumerate(points)}

    def be(vals):
        return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                             dtype=np.uint8).reshape(len(vals), 32).copy()

    e_b = np.stack([np.frombuffer(ln[1], dtype=np.uint8) for ln in lanes])
    r_b = be([ln[2] for ln in lanes])
    s_b = be([ln[3] for ln in lanes])
    kx = be_bytes_to_limbs(be([pt[0] for pt in points]))
    ky = be_bytes_to_limbs(be([pt[1] for pt in points]))
    idx = np.array([col[ln[0]] for ln in lanes], dtype=np.int32)
    valid = np.array([ln[4] for ln in lanes], dtype=bool)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bytes_args = [cuda(a) for a in (e_b, r_b, s_b, kx, ky, idx, valid)]
    limb_args = [cuda(a) for a in (be_bytes_to_limbs(e_b), be_bytes_to_limbs(r_b),
                                   be_bytes_to_limbs(s_b), kx[:, idx], ky[:, idx], valid)]
    results = {}
    for name, kernel, ref, args in (
        ("p256_verify_bytes", pk.verify_batch_bytes, pk.verify_batch_bytes_ref, bytes_args),
        ("p256_verify_limbs", pk.verify_batch, pk.verify_batch_ref, limb_args),
    ):
        got = kernel(*args)
        torch.cuda.synchronize()
        plain = ref(*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max().item())
        if got.tolist() != plain.tolist():
            raise AssertionError(f"{name}: kernel and plain masks differ")
        if got.tolist() != want1:
            raise AssertionError(f"{name}: mask differs from the oracle's")
        results[name] = {"max_abs_err": err}
        emit({"phase": "kernel_vs_plain", "kernel": name, "lanes": len(lanes),
              "accepted": sum(want1), "max_abs_err": err, "identical": True})
    # the table kernel: every word of each key column's comb
    tables = pk.key_tables(bytes_args[3], bytes_args[4])
    torch.cuda.synchronize()
    plain_tables = pk.key_tables_ref(bytes_args[3], bytes_args[4])
    err = int((tables.long() - plain_tables.long()).abs().max().item())
    if err:
        raise AssertionError("p256_key_tables: words differ from the plain version")
    results["p256_key_tables"] = {"max_abs_err": err}
    emit({"phase": "kernel_vs_plain", "kernel": "p256_key_tables", "keys": len(points),
          "words": tables.numel(), "max_abs_err": err, "identical": True})

    # --- phases 2-4: the main path through CUDAProvider -------------------
    prov = CUDAProvider(device=dev)
    if prov.describe_backend() != "cuda":
        raise AssertionError(f"provider runs on {prov.describe_backend()}")
    head_rows, head_want = tile(pool8, want8, 32768)
    block_rows, block_want = tile(pool3, want3, 3000)
    limb_rows, limb_want = tile(pool64, want64, 4096)
    keys32_rows, keys32_want = tile(pool32, want32, 1024)

    def cols(rows):
        return [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows]

    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    # headline: 3 timed passes, each with 2 batches in flight
    head = cols(head_rows)
    der_calls = native.CALLS["fn_batch_der_parse"]
    pass_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        first = prov.batch_verify_async(*head)
        second = prov.batch_verify_async(*head)
        masks = (first(), second())
        pass_s.append(time.perf_counter() - t0)
        for m in masks:
            if m != head_want:
                raise AssertionError("headline mask differs from the oracle's")
    parser = {"headline": der_parsed(native, der_calls, 6)}
    block = cols(block_rows)
    der_calls = native.CALLS["fn_batch_der_parse"]
    block_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = prov.batch_verify(*block)
        block_s.append(time.perf_counter() - t0)
        if m != block_want:
            raise AssertionError("block mask differs from the oracle's")
    parser["block"] = der_parsed(native, der_calls, 3)
    limb = cols(limb_rows)
    der_calls = native.CALLS["fn_batch_der_parse"]
    limb_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = prov.batch_verify(*limb)
        limb_s.append(time.perf_counter() - t0)
        if m != limb_want:
            raise AssertionError("limb-route mask differs from the oracle's")
    parser["limb_route"] = der_parsed(native, der_calls, 3)
    # every column of the key bucket in use (32 keys, the bytes route)
    if prov.batch_verify(*cols(keys32_rows)) != keys32_want:
        raise AssertionError("32-key mask differs from the oracle's")
    launches = dict(pk.LAUNCHES)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")
    # the provider keeps each key's comb by SKI: a table launch for a batch
    # with keys it has not seen (the headline's first, the 32-key batch)
    cached_keys = len(prov._key_table_cache)

    # --- kernel times at the main path's shapes ----------------------------
    head_prep_s = []
    der_calls = native.CALLS["fn_batch_der_parse"]
    for _ in range(3):
        t0 = time.perf_counter()
        prov.prep_bytes(*head)
        head_prep_s.append(time.perf_counter() - t0)
    der_parsed(native, der_calls, 3)
    # the block's and the limb route's batches step by step, as
    # batch_verify runs them: host prep, the inputs on the card (padding,
    # copies, the key combs), the kernel and its wait, the mask to the host
    batch_split = {}
    for label, batch in (("block", block), ("limb_route", limb)):
        batch_split[label] = []
        for _ in range(3):
            t0 = time.perf_counter()
            prep, limbs = prov.prep_bytes(*batch)
            t1 = time.perf_counter()
            fn, args = prov.device_inputs(prep, limbs, bucket(len(batch[0])))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            out[: len(batch[0])].tolist()
            t4 = time.perf_counter()
            batch_split[label].append({"host_prep": (t1 - t0) * 1e3, "inputs": (t2 - t1) * 1e3,
                                       "kernel_wait": (t3 - t2) * 1e3,
                                       "mask": (t4 - t3) * 1e3})

    def time_launch(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def bounds(work, nbytes: int):
        return p256_bounds(work, nbytes, imad_rate)

    comb_bytes = pk.g_comb_words().nbytes
    shapes = {}
    for label, batch in (("headline", head_rows), ("block", block_rows), ("limb", limb_rows),
                         ("keys32", keys32_rows)):
        size = bucket(len(batch))
        prep, limbs = prov.prep_bytes(*cols(batch))
        fn, args = prov.device_inputs(prep, limbs, size)
        ms = time_launch(lambda: fn(*args))
        live = int(args[-1].sum().item())
        nbytes = sum(a.numel() * a.element_size() for a in args) + size + comb_bytes
        if prep is not None:
            nkeys = len(prep[6])
            work = pk.work_bytes_route(live, nkeys, pk.live_blocks(args[-1].cpu().numpy()))
        else:
            nkeys = 0
            work = pk.work_limb_route(live)
        shapes[label] = {"fn": fn, "args": args, "ms": ms, "live": live, "lanes": size,
                         "keys": nkeys, **bounds(work, nbytes)}

    # the table kernel alone, at the block's 3 keys and the bucket's 32: its
    # time and its split (the chain, a doubling's cycles, the fill after the
    # chain) from the kept probe, its words against the plain version
    table_times = {}
    for label in ("block", "keys32"):
        kx_t, ky_t = (a[:, :shapes[label]["keys"]].contiguous() for a in shapes[label]["args"][3:5])
        nk = kx_t.shape[1]
        split = key_table_probe(torch, np, pk, kx_t, ky_t)
        least = nk * pk.LEAST_TABLE_MOD_P * pk.IMAD_MOD_P
        table_times[label] = {**split, **bounds(
            {"least": least, "kernel": nk * pk.KERNEL_MOD_P_TABLE * pk.IMAD_MOD_P},
            nk * (2 * 20 * 8 + pk.NUM_WINDOWS * 16 * 96))}
        got = pk.key_tables(kx_t, ky_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pk.key_tables_ref(kx_t, ky_t)
        torch.cuda.synchronize()
        table_times[label]["plain_ms"] = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            raise AssertionError(f"p256_key_tables: words differ from the plain version at {nk} keys")
        table_times[label]["words_equal_plain"] = True

    # plain versions on the card, once each, at the main path's shapes
    for label, ref in (("headline", pk.verify_batch_bytes_ref), ("limb", pk.verify_batch_ref),
                       ("keys32", pk.verify_batch_bytes_ref)):
        sh = shapes[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ref(*sh["args"])
        torch.cuda.synchronize()
        sh["plain_ms"] = (time.perf_counter() - t0) * 1e3
        got = sh["fn"](*sh["args"])
        if got.tolist() != plain.tolist():
            raise AssertionError(f"{label}: kernel and plain masks differ at full size")

    lanes_per_pass = 2 * len(head_rows)
    emit({"phase": "headline", "lanes": len(head_rows), "keys": 8, "in_flight": 2,
          "pass_seconds": pass_s,
          "verifies_per_s": [lanes_per_pass / s for s in pass_s],
          "kernel_ms": shapes["headline"]["ms"], "host_prep_ms": [t * 1e3 for t in head_prep_s],
          "parser": parser["headline"], "mask_equal_oracle": True})
    emit({"phase": "block", "lanes": len(block_rows), "keys": 3,
          "padded_to": bucket(len(block_rows)),
          "ms_per_batch": [s * 1e3 for s in block_s], "kernel_ms": shapes["block"]["ms"],
          "split_ms": batch_split["block"], "parser": parser["block"],
          "mask_equal_oracle": True})
    emit({"phase": "limb_route", "lanes": len(limb_rows), "keys": 65,
          "ms_per_batch": [s * 1e3 for s in limb_s], "kernel_ms": shapes["limb"]["ms"],
          "split_ms": batch_split["limb_route"], "parser": parser["limb_route"],
          "mask_equal_oracle": True})
    emit({"phase": "keys32", "lanes": len(keys32_rows), "keys": 32,
          "kernel_ms": shapes["keys32"]["ms"],
          "mask_equal_oracle": True, "mask_equal_plain": True})
    emit({"phase": "key_tables", "cached_by_ski": True, "cached_keys": cached_keys,
          "launches_on_main_path": launches["p256_key_tables"], **table_times})

    def bound_keys(sh):
        return {k: sh[k] for k in ("bound_ms", "bound_by", "bound_ms_kernel",
                                   "bound_ms_replaced")}

    kernels = []
    for name, label, replaces in (
        ("p256_verify_bytes", "headline", "fabric_tpu/ops/p256_kernel.py:499"),
        ("p256_verify_limbs", "limb", "fabric_tpu/ops/p256_kernel.py:386"),
    ):
        sh = shapes[label]
        kernels.append({
            "name": name, "route": "cuda", "source": "fabric_tpu_torch/csrc/p256_verify.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "lanes": sh["lanes"], "live_lanes": sh["live"],
            "threads_per_lane": pk.THREADS_PER_LANE,
            "ms": sh["ms"], "plain_ms": sh["plain_ms"], **bound_keys(sh), "library_ms": None,
        })
    tb = table_times["block"]
    kernels.append({
        "name": "p256_key_tables", "route": "cuda",
        "source": "fabric_tpu_torch/csrc/p256_verify.cu",
        "replaces": "fabric_tpu/ops/p256_kernel.py:499", "launches": launches["p256_key_tables"],
        "max_abs_err": results["p256_key_tables"]["max_abs_err"], "keys": tb["keys"],
        "ms": tb["ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "bound_ms_kernel": tb["bound_ms_kernel"],
        "library_ms": None, "chain_ms": tb["chain_ms"], "doubling_cycles": tb["doubling_cycles"],
        "keys32": {k: table_times["keys32"][k] for k in ("keys", "ms", "plain_ms", "bound_ms",
                                                          "chain_ms", "doubling_cycles")},
    })
    for label in ("block", "keys32"):
        sh = shapes[label]
        emit({"phase": f"{label}_kernel", "kernel": "p256_verify_bytes", "lanes": sh["lanes"],
              "live_lanes": sh["live"], "keys": sh["keys"], "ms": sh["ms"], **bound_keys(sh),
              "table_ms": table_times[label]["ms"]})
    der_sets = {"headline": head[1],
                "crafted": [der.marshal_signature(r, s) for _pt, _d, r, s, _v in crafted]}
    if keep is not None:
        keep["headline"], keep["limb"] = (head_rows, head_want), (limb_rows, limb_want)
    return (kernels, {"kernel_ms": shapes["block"]["ms"], "table_ms": table_times["block"]["ms"]},
            der_sets)


# ---------------------------------------------------------------------------
# The Idemix MSP (idemixgen, IdemixMSP, the identities' proofs on K4/K3) and
# the multi-device wrappers (ShardedVerify, MeshCUDAProvider, check_sharded)
# ---------------------------------------------------------------------------

IDEMIX_MSP_SEED = 2028
IDEMIX_MSP_NAME = "IdemixOrg"
IDEMIX_MSP_IDENTITIES = 16  # 4 OUs x (member, admin) x 2 enrollment ids
IDEMIX_MSP_OUS = 4
IDEMIX_MSP_MESSAGE = b"idemix_msp proposal"
MESH_POSITIONS = 4  # the card listed 4 times
MESH_RUNS = 3  # timed calls of each form, in turns


def _msp_outcome(fn, *args) -> str:
    from fabric_tpu_torch.msp.idemix_msp import IdemixMSPError

    try:
        fn(*args)
        return "ok"
    except IdemixMSPError as exc:
        return str(exc)


def _msp_identity_job(args) -> dict:
    """Pool worker: one identity's host side, as a peer's MSP runs it one
    identity at a time. (issuer key bytes, revocation PEM, signer config
    bytes, seed, principals) -> the serialized identity, the outcomes of
    validate, of satisfies_principal on each principal and of verify on the
    message and on another, the message's signature, the seconds taken."""
    import random

    from fabric_tpu_torch.common import p384
    from fabric_tpu_torch.msp import idemix_msp as im
    from fabric_tpu_torch.protos import fabric, wire

    ipk_raw, rev_pem, signer_raw, seed, principals = args
    t0 = time.perf_counter()
    msp = im.IdemixMSP({"name": IDEMIX_MSP_NAME, "ipk": ipk_raw}, p384.load_pem_public_key(rev_pem))
    signer = im.IdemixSigningIdentity(
        msp, wire.decode(fabric.IDEMIX_MSP_SIGNER_CONFIG, signer_raw), random.Random(seed))
    ident = msp.deserialize_identity(signer.serialize())
    sig = signer.sign(IDEMIX_MSP_MESSAGE)
    return {"raw": signer.serialize(), "validate": _msp_outcome(msp.validate, ident),
            "principals": [_msp_outcome(msp.satisfies_principal, ident, p) for p in principals],
            "sig": sig, "verify": [_msp_outcome(msp.verify, ident, m, sig)
                                   for m in (IDEMIX_MSP_MESSAGE, IDEMIX_MSP_MESSAGE + b"!")],
            "seconds": time.perf_counter() - t0}


def _msp_validate_job(args) -> str:
    """Pool worker: the host validate of serialized identity bytes under an
    issuer key's bytes: "ok" or the error."""
    from fabric_tpu_torch.msp import idemix_msp as im

    ipk_raw, raw = args
    msp = im.IdemixMSP({"name": IDEMIX_MSP_NAME, "ipk": ipk_raw})
    return _msp_outcome(lambda: msp.validate(msp.deserialize_identity(raw)))


def _with_claims(raw: bytes, change) -> bytes:
    """Serialized identity bytes with `change(inner)` applied to its
    SerializedIdemixIdentity dict."""
    from fabric_tpu_torch.protos import fabric, wire

    sid = wire.decode(fabric.SERIALIZED_IDENTITY, raw)
    inner = wire.decode(fabric.SERIALIZED_IDEMIX_IDENTITY, sid["id_bytes"])
    change(inner)
    return wire.encode(fabric.SERIALIZED_IDENTITY, dict(
        sid, id_bytes=wire.encode(fabric.SERIALIZED_IDEMIX_IDENTITY, inner)))


def idemix_msp_phase(torch, np, dev, identities=IDEMIX_MSP_IDENTITIES,
                     lanes=IDEMIX_SIZES[-1], workers=None) -> dict:
    """idemix_msp: the port's idemixgen writes an issuer and `identities`
    signer configs (4 OUs, MEMBER and ADMIN: the tool's roles) under
    build/smoke_idemix/, plus a CLIENT-mask and a PEER-mask credential
    (generate_signer_config) and another issuer's identity; IdemixMSP loads
    the directory. In a pool of spawned processes, as many as the host has
    cores (at most 8), each identity is made, deserialized, validated on the
    host, checked with satisfies_principal against a matching and a
    non-matching ROLE and OU principal, and signs a message that verifies
    (and fails on another). The identities' association proofs tiled to
    config #3's `lanes` go through verify_signatures_batch on the card
    (K4, K3): every lane True; a batch of tampered lanes (a flipped proof
    byte, a claimed ADMIN role, a claimed OU, another issuer's identity, the
    CLIENT- and PEER-mask credentials, whose proofs disclose MEMBER's mask)
    is False where the host validate is, lane by lane. The CRI's P-384
    signature passes verify_epoch_pk and fails once flipped; a weak
    Boneh-Boyen signature verifies and fails on another message. Returns the
    phase's K3 and K4 launches (counts zeroed at its start)."""
    import contextlib
    import io
    import multiprocessing
    import os
    import random
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from pathlib import Path

    from fabric_tpu_torch import idemix
    from fabric_tpu_torch.cli import idemixgen
    from fabric_tpu_torch.common import fp256bn as host
    from fabric_tpu_torch.common import p384
    from fabric_tpu_torch.idemix import batch as ib
    from fabric_tpu_torch.msp import idemix_msp as im
    from fabric_tpu_torch.ops import bn256_kernel as bk
    from fabric_tpu_torch.ops import pairing_kernel as pkn
    from fabric_tpu_torch.protos import fabric, wire
    from fabric_tpu_torch.protos import idemix as ipb

    t_phase = time.perf_counter()
    for k in pkn.LAUNCHES:
        pkn.LAUNCHES[k] = 0
    bk.LAUNCHES["bn256_msm"] = 0
    rng = random.Random(IDEMIX_MSP_SEED)
    root = Path(__file__).resolve().parent / "build" / "smoke_idemix"
    shutil.rmtree(root, ignore_errors=True)
    org, other = root / "org", root / "other"

    # --- idemixgen: the issuer, a signer config an identity ---------------
    t0 = time.perf_counter()
    specs = []  # (enrollment id, OU, role mask, signer config bytes)
    with contextlib.redirect_stdout(io.StringIO()):
        idemixgen.ca_keygen(str(org), random.Random(rng.getrandbits(64)))
        for i in range(identities):
            ou, enrollment = f"OU{i % IDEMIX_MSP_OUS + 1}", f"user{i}"
            admin = (i // IDEMIX_MSP_OUS) % 2 == 1
            idemixgen.signerconfig(str(org), ou, enrollment, admin,
                                   random.Random(rng.getrandbits(64)))
            dest = org / "users" / enrollment / "SignerConfig"
            dest.parent.mkdir(parents=True)
            os.replace(org / "user" / "SignerConfig", dest)
            specs.append((enrollment, ou, im.ROLE_ADMIN if admin else im.ROLE_MEMBER,
                          dest.read_bytes()))
        idemixgen.ca_keygen(str(other), random.Random(rng.getrandbits(64)))
        idemixgen.signerconfig(str(other), "OU1", "mallory", False,
                               random.Random(rng.getrandbits(64)))
    issuer_key = ipb.decode(ipb.ISSUER_KEY, (org / "ca" / "IssuerSecretKey").read_bytes())
    rev_key = p384.load_pem_private_key((org / "ca" / "RevocationKey").read_bytes())
    masks = {}
    for label, mask in (("client-mask", im.ROLE_CLIENT), ("peer-mask", im.ROLE_PEER)):
        masks[label] = wire.encode(fabric.IDEMIX_MSP_SIGNER_CONFIG, im.generate_signer_config(
            issuer_key, rev_key, "OU1", mask, label, random.Random(rng.getrandbits(64))))
    issue_s = time.perf_counter() - t0

    ipk_raw = (org / "msp" / "IssuerPublicKey").read_bytes()
    rev_pem = (org / "msp" / "RevocationPublicKey").read_bytes()
    rev_pk = p384.load_pem_public_key(rev_pem)
    msp = im.IdemixMSP({"name": IDEMIX_MSP_NAME, "ipk": ipk_raw, "revocation_pk": rev_pem}, rev_pk)
    other_ipk = (other / "msp" / "IssuerPublicKey").read_bytes()

    def role(r):
        return {"principal_classification": fabric.ROLE, "principal": wire.encode(
            fabric.MSP_ROLE, {"msp_identifier": IDEMIX_MSP_NAME, "role": r})}

    def ou_principal(ou):
        return {"principal_classification": fabric.ORGANIZATION_UNIT, "principal": wire.encode(
            fabric.ORGANIZATION_UNIT_MSG, {"msp_identifier": IDEMIX_MSP_NAME,
                                           "organizational_unit_identifier": ou})}

    # per identity: its role (match), a role it lacks, its OU, the next OU
    jobs, expected = [], []
    for i, (enrollment, ou, mask, signer_raw) in enumerate(specs):
        next_ou = f"OU{(i + 1) % IDEMIX_MSP_OUS + 1}"
        if mask == im.ROLE_ADMIN:
            lacking = fabric.CLIENT if i % 2 else fabric.PEER
            principals = [role(fabric.ADMIN), role(lacking)]
            want = ["ok", "user does not have the required role"]
        else:
            principals = [role(fabric.MEMBER), role(fabric.ADMIN)]
            want = ["ok", "user is not an admin"]
        principals += [ou_principal(ou), ou_principal(next_ou)]
        expected.append(want + ["ok", "OU identifier does not match"])
        jobs.append((ipk_raw, rev_pem, signer_raw, IDEMIX_MSP_SEED + i, principals))
    extra = {label: (ipk_raw, rev_pem, raw, IDEMIX_MSP_SEED + 100 + k, [])
             for k, (label, raw) in enumerate(masks.items())}
    extra["other-issuer"] = (other_ipk, (other / "msp" / "RevocationPublicKey").read_bytes(),
                             (other / "user" / "SignerConfig").read_bytes(),
                             IDEMIX_MSP_SEED + 200, [])
    workers = workers or min(8, len(os.sched_getaffinity(0)))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(_msp_identity_job, jobs + list(extra.values())))
        host_s = time.perf_counter() - t0
        results, extra_results = done[:len(jobs)], dict(zip(extra, done[len(jobs):]))
        for i, (res, want) in enumerate(zip(results, expected)):
            if (res["validate"] != "ok" or res["principals"] != want
                    or res["verify"][0] != "ok" or res["verify"][1] == "ok"):
                raise AssertionError(f"idemix_msp: identity {i} on the host: {res}, want {want}")
        idents = [msp.deserialize_identity(res["raw"]) for res in results]
        for ident, res in zip(idents, results):  # the signatures again, in this process
            msp.verify(ident, IDEMIX_MSP_MESSAGE, res["sig"])
        for (enrollment, ou, mask, _), ident in zip(specs, idents):
            if ident.ou_identifier != ou or ident.role_mask != mask:
                raise AssertionError(f"idemix_msp: {enrollment} reads {ident.ou_identifier}, "
                                     f"{ident.role_mask}")

        # the tampered lanes, validated on the host in the pool
        member, admin = results[0]["raw"], results[IDEMIX_MSP_OUS]["raw"]

        def flip_proof(inner):
            proof = ipb.decode(ipb.SIGNATURE, inner["proof"])
            proof["proof_c"] = bytes([proof["proof_c"][0] ^ 1]) + proof["proof_c"][1:]
            inner["proof"] = ipb.encode(ipb.SIGNATURE, proof)

        def claim_admin(inner):
            inner["role"] = wire.encode(fabric.MSP_ROLE, {"msp_identifier": IDEMIX_MSP_NAME,
                                                          "role": fabric.ADMIN})

        def claim_ou(inner):
            inner["ou"] = wire.encode(fabric.ORGANIZATION_UNIT_MSG, {
                "msp_identifier": IDEMIX_MSP_NAME, "organizational_unit_identifier": "OU9"})

        # under this MSP's issuer key; the CLIENT- and PEER-mask credentials'
        # identities were validated under it in their jobs
        tampered = {"flipped-proof-byte": _with_claims(member, flip_proof),
                    "claimed-admin": _with_claims(member, claim_admin),
                    "claimed-ou": _with_claims(member, claim_ou),
                    "other-issuer": extra_results["other-issuer"]["raw"]}
        tampered_verdicts = dict(zip(tampered, pool.map(
            _msp_validate_job, [(ipk_raw, raw) for raw in tampered.values()])))
    mixed = [("member", member, results[0]["validate"]),
             ("admin", admin, results[IDEMIX_MSP_OUS]["validate"])]
    mixed += [(label, raw, tampered_verdicts[label]) for label, raw in tampered.items()]
    mixed += [(label, extra_results[label]["raw"], extra_results[label]["validate"])
              for label in masks]

    # --- the proofs on the card, config #3's lanes -------------------------
    def batch_args(batch_idents):
        return ([x.proof for x in batch_idents], [im.PROOF_DISCLOSURE] * len(batch_idents),
                msp.ipk, [b""] * len(batch_idents),
                [msp.proof_attribute_values(x) for x in batch_idents], im.RH_INDEX)

    tiled = batch_args([idents[i % len(idents)] for i in range(lanes)])
    batch_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        mask = ib.verify_signatures_batch(*tiled, device=dev)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if mask != [True] * lanes:
            raise AssertionError(f"idemix_msp: {mask.count(False)} proof lanes refused on the card")
    mixed_idents = [msp.deserialize_identity(raw) for _, raw, _ in mixed]
    got = ib.verify_signatures_batch(*batch_args(mixed_idents), device=dev)
    host_verdicts = [v == "ok" for _, _, v in mixed]
    if got != host_verdicts or host_verdicts != [True, True] + [False] * (len(mixed) - 2):
        raise AssertionError(f"idemix_msp: tampered lanes {got}, host {[v for *_, v in mixed]}")

    # --- the CRI's P-384 signature, a weak Boneh-Boyen signature ----------
    signer_config = wire.decode(fabric.IDEMIX_MSP_SIGNER_CONFIG, specs[0][3])
    cri = ipb.decode(ipb.CREDENTIAL_REVOCATION_INFORMATION,
                     signer_config["credential_revocation_information"])
    cri_args = (cri["epoch_pk"], cri.get("epoch", 0), cri.get("revocation_alg", 0))
    idemix.verify_epoch_pk(rev_pk, cri_args[0], cri["epoch_pk_sig"], *cri_args[1:])
    flipped = bytearray(cri["epoch_pk_sig"])
    flipped[10] ^= 1
    try:
        idemix.verify_epoch_pk(rev_pk, cri_args[0], bytes(flipped), *cri_args[1:])
        raise AssertionError("idemix_msp: a flipped CRI signature verified")
    except idemix.IdemixError:
        pass
    wbb_sk, wbb_pk = idemix.wbb_keygen(rng)
    m = host.rand_mod_order(rng)
    wbb_sig = idemix.wbb_sign(wbb_sk, m)
    idemix.wbb_verify(wbb_pk, wbb_sig, m)
    try:
        idemix.wbb_verify(wbb_pk, wbb_sig, m + 1)
        raise AssertionError("idemix_msp: a weak-BB signature verified on another message")
    except idemix.IdemixError:
        pass
    launches = {"ate2_unity": pkn.LAUNCHES["ate2_unity"], "bn256_msm": bk.LAUNCHES["bn256_msm"]}
    if launches != {"ate2_unity": 4, "bn256_msm": 4}:
        raise AssertionError(f"idemix_msp: launches {launches}, want a K4 and a K3 a batch")
    emit({"phase": "idemix_msp", "identities": identities, "ous": IDEMIX_MSP_OUS,
          "roles": ["MEMBER", "ADMIN"], "issue_seconds": issue_s, "workers": workers,
          "host_seconds": host_s,
          "host_seconds_per_identity": [r["seconds"] for r in results],
          "principal_checks": sum(len(r["principals"]) for r in results),
          "proof_lanes": lanes, "batch_ms": batch_ms, "proof_lanes_all_true": True,
          "mixed_lanes": [label for label, _, _ in mixed], "mixed_mask": got,
          "mixed_equal_host_validate": True, "cri_verified": True, "cri_flipped_refused": True,
          "wbb_verified": True, "wbb_other_message_refused": True, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def mesh_sharded_phase(torch, np, dev, inputs: dict) -> dict:
    """mesh_sharded: the multi-device wrappers on one card. `inputs` holds
    the headline's and the limb route's rows and oracle masks (p256_phases),
    config #2's envelopes and network (validator_phases), config #5's blocks
    and flags (multichannel_phase) and config #3's batch (idemix_phases).
    ShardedVerify.verify_flat at config #1's 32,768 lanes over flat_mesh()
    (1 K1 launch) and over the card listed 4 times (4); MeshCUDAProvider
    over that mesh: config #2's block through BlockValidator (one K2
    launch, unsharded, as the reference's batch_verify) and its _run_kernel
    on the limb route (4 K1 launches); MultiChannelValidator over
    grid_mesh(4, 1) on config #5's four channels (4 K1 launches a validate);
    Ate2Kernel.check_sharded at config #3's 256 lanes over the 4-times mesh
    (4 K4 launches). Every mask and flag byte equal to the unsharded launch
    on the same inputs, each call form timed in turns. flat_mesh() spans
    every card of the host, so its call is one K1 launch a card. On a host
    with more than one card (`distinct_devices`, after the path's counts are
    read), the same calls over distinct cards: verify_flat over flat_mesh()
    and grid_mesh(2, 2), MeshCUDAProvider's _run_kernel over flat_mesh(),
    MultiChannelValidator over grid_mesh(4, 1) and grid_mesh(2, 2), and
    check_sharded over flat_mesh(), every mask and flag byte equal to the
    unsharded launch's and each position's launch on its own card. Returns
    the phase's launches (counts zeroed at its start)."""
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.idemix import scheme
    from fabric_tpu_torch.ops import p256_kernel as pk
    from fabric_tpu_torch.ops import pairing_kernel as pkn
    from fabric_tpu_torch.parallel import (MeshCUDAProvider, MultiChannelValidator,
                                           ShardedVerify, flat_mesh, grid_mesh)
    from fabric_tpu_torch.protos import fabric, wire

    t_phase = time.perf_counter()
    for table in (pk.LAUNCHES, pkn.LAUNCHES):
        for k in table:
            table[k] = 0

    def cols(rows):
        return [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows]

    def k1_delta(before):
        return pk.LAUNCHES["p256_verify_limbs"] - before

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    mesh4 = flat_mesh([dev] * MESH_POSITIONS)
    prov = CUDAProvider(device=dev)
    head_rows, head_want = inputs["headline"]
    limbs = prov.prep_limbs(*cols(head_rows))

    # --- verify_flat at config #1's 32,768 lanes --------------------------
    def unsharded():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in limbs]
        return np.array(pk.verify_batch(*args).cpu().tolist(), dtype=bool)

    n_cards = torch.cuda.device_count()
    flat, four = ShardedVerify(flat_mesh()), ShardedVerify(mesh4)
    forms = {"unsharded": unsharded, "flat_mesh": lambda: flat.verify_flat(*limbs),
             "mesh4": lambda: four.verify_flat(*limbs)}
    per_call = {"unsharded": 1, "flat_mesh": n_cards, "mesh4": MESH_POSITIONS}
    flat_ms = {name: [] for name in forms}
    for _ in range(MESH_RUNS):
        for name, fn in forms.items():
            before = pk.LAUNCHES["p256_verify_limbs"]
            mask, ms = timed(fn)
            flat_ms[name].append(ms)
            if k1_delta(before) != per_call[name]:
                raise AssertionError(f"mesh_sharded: {name} took {k1_delta(before)} K1 launches")
            if mask.tolist() != head_want:
                raise AssertionError(f"mesh_sharded: {name} mask differs from the unsharded one")
    k1_flat = pk.LAUNCHES["p256_verify_limbs"]

    # --- MeshCUDAProvider: config #2's block (K2), the limb route (K1) ------
    net = inputs["net"]
    mprov = MeshCUDAProvider(mesh4)
    raw_block = wire.encode(fabric.BLOCK, net.make_block(inputs["config2"], 1))
    block_flags, block_ms = {}, {}
    for name, provider in (("cuda", prov), ("mesh", mprov)):
        k2 = pk.LAUNCHES["p256_verify_bytes"]
        before = pk.LAUNCHES["p256_verify_limbs"]
        validator = net.validator(provider)
        flags, ms = timed(lambda: validator.validate(wire.decode(fabric.BLOCK, raw_block)))
        block_flags[name], block_ms[name] = flags.tobytes(), ms
        if pk.LAUNCHES["p256_verify_bytes"] - k2 != 1 or k1_delta(before):
            raise AssertionError(f"mesh_sharded: {name} provider's block took other launches")
    if block_flags["mesh"] != block_flags["cuda"] or block_flags["mesh"] != bytes(
            len(inputs["config2"])):
        raise AssertionError("mesh_sharded: MeshCUDAProvider's block flags differ")
    limb_rows, limb_want = inputs["limb"]
    before = pk.LAUNCHES["p256_verify_limbs"]
    sharded_limb, limb_ms = timed(lambda: mprov._run_kernel(mprov.prep_limbs(*cols(limb_rows))))
    if k1_delta(before) != MESH_POSITIONS:
        raise AssertionError("mesh_sharded: _run_kernel must launch K1 once a position")
    before = pk.LAUNCHES["p256_verify_limbs"]
    plain_limb, limb_unsharded_ms = timed(lambda: prov.batch_verify(*cols(limb_rows)))
    if k1_delta(before) != 1 or sharded_limb != plain_limb or plain_limb != limb_want:
        raise AssertionError("mesh_sharded: the limb route's sharded mask differs")

    # --- MultiChannelValidator over grid_mesh(4, 1): config #5 ---------------
    c5 = inputs["config5"]
    channels = sorted(c5["raw"])

    def multi(**where):
        return MultiChannelValidator({ch: c5["net"].validator(CUDAProvider(device=dev), channel=ch)
                                      for ch in channels}, **where)

    validators = {"unsharded": (multi(device=dev), 1),
                  "grid": (multi(mesh=grid_mesh(MESH_POSITIONS, 1, [dev] * MESH_POSITIONS)),
                           MESH_POSITIONS)}
    c5_ms = {name: [] for name in validators}
    for _ in range(2):
        for name, (mv, launches_per) in validators.items():
            before = pk.LAUNCHES["p256_verify_limbs"]
            flags, ms = timed(lambda: mv.validate(
                {ch: wire.decode(fabric.BLOCK, c5["raw"][ch]) for ch in channels}))
            c5_ms[name].append(ms)
            if k1_delta(before) != launches_per:
                raise AssertionError(f"mesh_sharded: config #5 {name}: {k1_delta(before)} K1")
            if any(flags[ch].tobytes() != c5["alone"][ch] for ch in channels):
                raise AssertionError(f"mesh_sharded: config #5 {name} flags differ")

    # --- check_sharded at config #3's 256 lanes -----------------------------
    sigs, ipk = inputs["config3"][0], inputs["config3"][2]
    pairs = [(scheme.ecp_from_proto(s["a_prime"]), scheme.ecp_from_proto(s["a_bar"]))
             for s in sigs]
    kernel = pkn.Ate2Kernel(scheme.ecp2_from_proto(ipk["w"]), dev)
    k4_ms = {"check": [], "check_sharded": []}
    for _ in range(MESH_RUNS):
        before = pkn.LAUNCHES["ate2_unity"]
        whole, ms = timed(lambda: kernel.check(pairs))
        k4_ms["check"].append(ms)
        split, ms = timed(lambda: kernel.check_sharded(pairs, mesh4))
        k4_ms["check_sharded"].append(ms)
        if pkn.LAUNCHES["ate2_unity"] - before != 1 + MESH_POSITIONS:
            raise AssertionError("mesh_sharded: check_sharded must launch K4 once a position")
        if split != whole or whole != [True] * len(pairs):
            raise AssertionError("mesh_sharded: check_sharded verdicts differ from check's")
    launches = {"p256_verify_limbs": pk.LAUNCHES["p256_verify_limbs"],
                "p256_verify_bytes": pk.LAUNCHES["p256_verify_bytes"],
                "p256_key_tables": pk.LAUNCHES["p256_key_tables"],
                "ate2_unity": pkn.LAUNCHES["ate2_unity"]}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"mesh_sharded: {name} never launched")
    # K1 alone at the headline's shape and at a position's quarter of it, after
    # the counts are read: these launches are not the path's
    resident = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in limbs]
    quarter = [a[..., :a.shape[-1] // MESH_POSITIONS].contiguous() for a in resident]
    k1_ms = {"full": device_ms(torch, lambda: pk.verify_batch(*resident), 3),
             "quarter": device_ms(torch, lambda: pk.verify_batch(*quarter), 3)}
    distinct = None
    if n_cards > 1:
        distinct = mesh_distinct_devices(torch, np, dev, inputs, limbs, cols, pairs, kernel,
                                         unsharded_mask=head_want, block_flags=block_flags["cuda"],
                                         limb_mask=plain_limb)
    emit({"phase": "mesh_sharded", "positions": MESH_POSITIONS, "cards": n_cards,
          "verify_flat": {"lanes": len(head_rows), "ms": flat_ms, "k1_per_call": per_call,
                          "k1_device_ms": k1_ms, "masks_equal_unsharded": True},
          "provider": {"block_ms": block_ms, "k2_per_block": 1, "block_flags_equal": True,
                       "limb_lanes": len(limb_rows), "limb_ms": limb_ms,
                       "limb_unsharded_ms": limb_unsharded_ms, "k1_per_run_kernel": MESH_POSITIONS,
                       "limb_mask_equal_unsharded": True},
          "config5": {"channels": len(channels), "ms": c5_ms,
                      "k1_per_validate": {"unsharded": 1, "grid": MESH_POSITIONS},
                      "flags_equal_each_channel": True},
          "check_sharded": {"lanes": len(pairs), "ms": k4_ms,
                            "k4_per_call": {"check": 1, "check_sharded": MESH_POSITIONS},
                            "verdicts_equal_check": True},
          "k1_launches_verify_flat": k1_flat, "launches": launches,
          "distinct_devices": distinct,
          "seconds": time.perf_counter() - t_phase})
    return launches


def mesh_distinct_devices(torch, np, dev, inputs: dict, limbs, cols, pairs, kernel,
                          unsharded_mask, block_flags, limb_mask) -> dict:
    """mesh_sharded over distinct cards (a host with more than one): each
    call form over meshes of different cards, every mask and flag byte equal
    to the unsharded launch's (`unsharded_mask`, `block_flags`, `limb_mask`,
    config #5's flags each channel alone), and the device of every K1 and
    K4 launch recorded by wrapping the wrappers the mesh code calls: the
    launches of a call run one on each position's card. Returns what each
    form launched where."""
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.ops import p256_kernel as pk
    from fabric_tpu_torch.ops import pairing_kernel as pkn
    from fabric_tpu_torch.parallel import (MeshCUDAProvider, MultiChannelValidator,
                                           ShardedVerify, flat_mesh, grid_mesh)
    from fabric_tpu_torch.protos import fabric, wire

    seen = []
    real_k1, real_k4 = pk.verify_batch, pkn.unity_check

    def k1(*args, **kw):
        seen.append(("K1", str(args[0].device)))
        return real_k1(*args, **kw)

    def k4(tables, *cols_, **kw):
        seen.append(("K4", str(cols_[0].device)))
        return real_k4(tables, *cols_, **kw)

    n_cards = torch.cuda.device_count()
    meshes = {"flat_mesh": flat_mesh()}
    if n_cards >= 4:
        meshes.update(grid_2x2=grid_mesh(2, 2), grid_4x1=grid_mesh(4, 1))
    out = {}

    def check(name, mesh, fn, want, kind="K1", row=False):
        del seen[:]
        got = fn()
        positions = [str(d) for d in (mesh.grid()[0] if row else mesh.grid().reshape(-1))]
        launched = [d for k, d in seen if k == kind]
        if got != want:
            raise AssertionError(f"mesh_sharded: {name} over distinct cards differs from the "
                                 f"unsharded launch")
        if sorted(launched) != sorted(positions) or len(set(launched)) != len(launched):
            raise AssertionError(f"mesh_sharded: {name} launched on {launched}, mesh {positions}")
        out[name] = {"mesh": str(mesh), "launches_on": launched, "equal_unsharded": True}

    c5 = inputs["config5"]
    channels = sorted(c5["raw"])

    def c5_flags(mv):
        flags = mv.validate({ch: wire.decode(fabric.BLOCK, c5["raw"][ch]) for ch in channels})
        return [flags[ch].tobytes() for ch in channels]

    pk.verify_batch, pkn.unity_check = k1, k4
    try:
        for label, mesh in meshes.items():
            sv = ShardedVerify(mesh)
            check(f"verify_flat/{label}", mesh, lambda: sv.verify_flat(*limbs).tolist(),
                  unsharded_mask, row=True)
            mv = MultiChannelValidator({ch: c5["net"].validator(CUDAProvider(device=dev),
                                                                channel=ch)
                                        for ch in channels}, mesh=mesh)
            check(f"config5/{label}", mesh, lambda: c5_flags(mv),
                  [c5["alone"][ch] for ch in channels])
        mesh = meshes["flat_mesh"]
        mprov = MeshCUDAProvider(mesh)
        limb_rows = inputs["limb"][0]
        check("run_kernel/flat_mesh", mesh,
              lambda: mprov._run_kernel(mprov.prep_limbs(*cols(limb_rows))), limb_mask, row=True)
        raw_block = wire.encode(fabric.BLOCK, inputs["net"].make_block(inputs["config2"], 1))
        flags = inputs["net"].validator(mprov).validate(wire.decode(fabric.BLOCK, raw_block))
        if flags.tobytes() != block_flags:
            raise AssertionError("mesh_sharded: MeshCUDAProvider's block over distinct cards")
        check("check_sharded/flat_mesh", mesh, lambda: kernel.check_sharded(pairs, mesh),
              kernel.check(pairs), kind="K4")
    finally:
        pk.verify_batch, pkn.unity_check = real_k1, real_k4
    return {"cards": n_cards, "forms": out}


# ---------------------------------------------------------------------------
# The endorsement side and the solo orderer: endorse_config2
# ---------------------------------------------------------------------------

ENDORSE_SEED = CONFIG2_SEED + 16  # the orderer org's material (ConfigNet) beside Config2Net's
# three blocks of proposals: (round's name, its block's MVCC conflicts,
# proposals with a flipped client signature, envelopes with a flipped
# endorsement signature)
ENDORSE_ROUNDS = (("put", False, 0, 0), ("read_write", True, 0, 0), ("refused", False, 8, 4))
# the solo orderer's BatchSize: MaxMessageCount is the block's 1,000 txs;
# PreferredMaxBytes and AbsoluteMaxBytes are configtx.yaml's AbsoluteMaxBytes
# (99 MB), so the count cuts (a config #2 block of 1,000 envelopes holds
# about 3 MB, past the 2 MB PreferredMaxBytes default)
ENDORSE_MAX_BYTES = 99 * 1024 * 1024
# the etcdraft cluster of raft_config2: the smallest that survives losing a node
RAFT_CONSENTERS = 3


class BenchCC:
    """benchcc as endorse_config2 runs it in process, over either package's
    shim module (`shim`): `put k` writes k (config #2's transaction shape,
    one write); `rw k [k2]` reads each key and writes k (config #4's
    in-block conflict pattern when k2 is written earlier in the block)."""

    def __init__(self, shim):
        self.shim = shim

    def init(self, stub):
        return self.shim.success()

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        if fn == "put" and len(params) == 1:
            stub.put_state(params[0], b"v")
            return self.shim.success()
        if fn == "rw" and params:
            for key in params:
                stub.get_state(key)
            stub.put_state(params[0], b"w")
            return self.shim.success()
        return self.shim.error_response(f"benchcc: unknown function {fn}")


class EndorseNet:
    """endorse_config2's network and traffic: Config2Net's Org1-3, client
    and endorsing peers (bench.py `_Net`, 314-388) and ConfigNet's orderer
    org and genesis block (the port's encoder), minted from `seed`; the
    proposals of each round of ENDORSE_ROUNDS, the codes each block must
    get, computed from the round alone.

    The genesis is an etcdraft channel's: RAFT_CONSENTERS consenters of the
    orderer org and a BatchSize of `n_txs` messages and ENDORSE_MAX_BYTES.
    endorse_config2's SoloChain orders on it (a solo chain reads no
    consensus type) and raft_config2's cluster joins it, so the two phases
    order the same envelopes into the same chain of blocks."""

    def __init__(self, seed=ENDORSE_SEED, channel=CONFIG2_CHANNEL, n_txs=CONFIG2_TXS):
        self.net = Config2Net(seed=seed)
        self.cn = ConfigNet(self.net, seed=seed + 1)
        self.channel = channel
        self.consenters = [(f"orderer{i}.orderer.bench", 7050, b"", b"")
                           for i in range(1, RAFT_CONSENTERS + 1)]
        self.genesis = self.cn.genesis(channel, orderer_type="etcdraft",
                                       raft_consenters=self.consenters,
                                       max_message_count=n_txs,
                                       absolute_max_bytes=ENDORSE_MAX_BYTES,
                                       preferred_max_bytes=ENDORSE_MAX_BYTES)

    def consenter_signers(self):
        """A SigningIdentity of the orderer org for each consenter and one
        for the follower orderer, enrolled from the org's CA."""
        import random

        from fabric_tpu_torch.msp.signer import SigningIdentity

        rng = random.Random(f"consenters {self.channel}")
        return [SigningIdentity(self.cn.orderer_org.ca.enroll(
            f"orderer{i}.orderer.bench", ou="orderer"), rng)
            for i in range(1, RAFT_CONSENTERS + 2)]

    @staticmethod
    def args(conflict: bool, i: int):
        """Proposal i's chaincode arguments: `put k{i}`, or with `conflict`
        `rw k{i}` that also reads k{i-1} when i % 10 == 9."""
        if not conflict:
            return [b"put", b"k%d" % i]
        return [b"rw", b"k%d" % i] + ([b"k%d" % (i - 1)] if i % 10 == 9 else [])

    def refused(self, rnd: int, n: int, refused: int) -> set:
        """The proposals of round `rnd` (of `n`) with a flipped client signature."""
        import random

        return set(random.Random(f"refused {self.channel} {rnd}").sample(range(n), refused))

    def flipped(self, rnd: int, n_txs: int, flipped: int) -> set:
        """The ordered envelopes of round `rnd` with a flipped endorsement
        signature: `flipped` (at most n_txs // 10) positions 10 j + 3, away
        from the conflict pattern."""
        import random

        slots = random.Random(f"flipped {self.channel} {rnd}").sample(
            range(n_txs // 10), min(flipped, n_txs // 10))
        return {10 * j + 3 for j in slots}

    def proposals(self, rnd: int, n_txs: int):
        """Round `rnd`'s proposals, client-signed: [(bundle, SignedProposal,
        refused)], n_txs + the round's refused ones. The client's random
        stream is reseeded from the channel and the round first."""
        from fabric_tpu_torch.endorser import txbuilder as tb

        _, conflict, refused, _ = ENDORSE_ROUNDS[rnd]
        n = n_txs + refused
        bad = self.refused(rnd, n, refused)
        self.net.rng.seed(f"endorse {self.channel} {rnd}")
        out = []
        for i in range(n):
            bundle = tb.create_proposal(self.net.client, self.channel, "benchcc",
                                        self.args(conflict, i))
            signed = tb.create_signed_proposal(bundle, self.net.client)
            if i in bad:
                sig = signed["signature"]
                signed = {**signed, "signature": sig[:-1] + bytes([sig[-1] ^ 0x01])}
            out.append((bundle, signed, i in bad))
        return out

    def envelopes(self, rnd: int, endorsed, n_txs: int):
        """The client's envelopes of round `rnd` from `endorsed` ([(bundle,
        [responses])] of the proposals both peers endorsed, in order), the
        round's flipped endorsements re-signed with one signature flipped."""
        from fabric_tpu_torch.endorser import txbuilder as tb

        flip = self.flipped(rnd, n_txs, ENDORSE_ROUNDS[rnd][3])
        out = []
        for j, (bundle, responses) in enumerate(endorsed):
            env = tb.create_signed_tx(bundle, self.net.client, responses)
            out.append(self.net.resigned(env, self.net.flip_endorsement) if j in flip else env)
        return out

    def codes(self, rnd: int, n_txs: int) -> bytes:
        """The TRANSACTIONS_FILTER round `rnd`'s block must get."""
        _, conflict, _, flipped = ENDORSE_ROUNDS[rnd]
        codes = [MASK_CODES["valid"]] * n_txs
        if conflict:
            for i in range(9, n_txs, 10):
                codes[i] = 11  # MVCC_READ_CONFLICT
        for j in self.flipped(rnd, n_txs, flipped):
            codes[j] = MASK_CODES["bad_endorsement"]
        return bytes(codes)


def endorsing_peer(en, k: int, path: str, provider, dev, endorser_cls=None, signer=None,
                   device_mvcc=True):
    """Peer k of endorse_config2 (Org1's for k = 0, Org2's for k = 1): a
    bundle of the genesis block over `provider` (its MSPs verify a
    creator's signature there), a Channel with the orderer's signature
    checked through `block_signature_verifier` and the genesis block
    committed, a ChaincodeSupport with benchcc and qscc, and an Endorser
    (`endorser_cls`, default Endorser) signing with the peer's identity
    (or `signer`). Returns (channel, endorser)."""
    from fabric_tpu_torch.chaincode import shim
    from fabric_tpu_torch.chaincode.support import ChaincodeSupport
    from fabric_tpu_torch.channelconfig.bundle import bundle_from_genesis_block
    from fabric_tpu_torch.endorser.endorser import Endorser
    from fabric_tpu_torch.orderer.blockwriter import block_signature_verifier
    from fabric_tpu_torch.peer.channel import Channel
    from fabric_tpu_torch.protos import fabric, wire
    from fabric_tpu_torch.scc.qscc import QSCC
    from fabric_tpu_torch.validation.validator import ChaincodeDefinition, ChaincodeRegistry

    genesis_raw = wire.encode(fabric.BLOCK, en.genesis)
    bundle = bundle_from_genesis_block(wire.decode(fabric.BLOCK, genesis_raw), provider)
    registry = ChaincodeRegistry([ChaincodeDefinition("benchcc", en.net.policy)])
    ch = Channel(en.channel, path, bundle.msp_manager, registry, provider,
                 verify_orderer_sig=block_signature_verifier(lambda: bundle),
                 device_mvcc=device_mvcc, device=dev)
    ch.ledger.commit(wire.decode(fabric.BLOCK, genesis_raw))
    support = ChaincodeSupport()
    support.register("benchcc", BenchCC(shim))
    support.register("qscc", QSCC(lambda cid: ch.ledger if cid == en.channel else None),
                     system=True)
    endorser = (endorser_cls or Endorser)(
        signer or en.net.endorsers[k], bundle.msp_manager, support,
        get_ledger=lambda cid: ch.ledger if cid == en.channel else None)
    return ch, endorser


def endorse_phase(torch, np, dev, n_txs=CONFIG2_TXS, keep=None) -> dict:
    """endorse_config2: Fabric's transaction flow at config #2's width on the
    card, proposal -> endorse -> order -> validate -> commit. Org1's client
    signs each round's proposals (`EndorseNet`); Org1's and Org2's peers
    (`endorsing_peer`) each check the creator through their bundle's MSPs
    (Identity.verify: one K2 launch of one lane), simulate benchcc over
    their committed state and sign a response; the client assembles the
    envelopes from the two equal responses; a SoloChain
    (BatchConfig(max_message_count=1000) with ENDORSE_MAX_BYTES, the
    orderer org's signer) cuts and signs one block a round and delivers it to both peers'
    CommitPipelines, whose Channels check its orderer signature through
    `block_signature_verifier` and validate and commit it (K2, the key
    combs, K5). Both peers' Channels and MSPs share one
    BatchingProvider(CUDAProvider). A round's proposals are endorsed only
    after the previous block committed on both peers, as a Fabric client
    waits for its commit event: a simulation reads the state the
    committer thread writes. Rounds: 1,000 `put k{i}`; 1,000 read-writes
    with config #4's conflict pattern (100 MVCC_READ_CONFLICT); 1,008
    proposals of which 8 carry a flipped client signature (both endorsers
    answer 500 "access denied"; never ordered) and 4 ordered envelopes a
    flipped endorsement signature (ENDORSEMENT_POLICY_FAILURE). Then qscc
    through Org1's endorser: GetChainInfo, GetBlockByNumber(2) and
    GetTransactionByID of a conflicted tx, each against the committed
    ledger. Checks: every response's status; each filter against
    EndorseNet.codes; both peers' filters, commit hashes, .chain bytes and
    SQLite rows equal; the same blocks stored serially on a third ledger
    with the host MVCC equal; every K2 lane (each creator check's and each
    batch's) held against SoftwareProvider(hostec_np); K2 once a creator
    check and at least once a block, the key combs, K5 once a block on
    each peer. Returns the phase's launches of K2, the key combs and K5;
    with `keep`, keeps under keep["endorse_config2"] what raft_config2
    orders again: the network, each round's envelopes, the blocks as the
    solo chain delivered them, both peers' (filter, commit hash) pairs and
    the committed .chain blocks and SQLite rows of peer 0."""
    import shutil
    import threading
    from pathlib import Path

    from fabric_tpu_torch.chaincode import shim  # noqa: F401 - benchcc's shim
    from fabric_tpu_torch.crypto import factory, hostec, hostec_np
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.endorser.endorser import Endorser
    from fabric_tpu_torch.endorser import txbuilder as tb
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.orderer.blockcutter import BatchConfig
    from fabric_tpu_torch.orderer.solo import SoloChain
    from fabric_tpu_torch.parallel.batcher import BatchingProvider
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.protos import fabric, protoutil, wire

    t_phase = time.perf_counter()
    rounds = ENDORSE_ROUNDS
    en = EndorseNet(n_txs=n_txs)
    root = Path(__file__).resolve().parent / "build" / "smoke_endorse"
    shutil.rmtree(root, ignore_errors=True)
    times = {"validate": 0.0, "simulate_endorse": 0.0, "sign": 0.0, "process": [0.0, 0.0]}

    class TimedEndorser(Endorser):
        """Endorser with each step's host seconds added to `times`."""

        def _validate(self, up):
            t0 = time.perf_counter()
            try:
                return super()._validate(up)
            finally:
                times["validate"] += time.perf_counter() - t0

        def _simulate_and_endorse(self, up):
            t0 = time.perf_counter()
            try:
                return super()._simulate_and_endorse(up)
            finally:
                times["simulate_endorse"] += time.perf_counter() - t0

    class TimedSigner:
        """A peer's SigningIdentity with its signing seconds added to `times`."""

        def __init__(self, signer):
            self._signer = signer

        def serialize(self):
            return self._signer.serialize()

        def sign(self, msg):
            t0 = time.perf_counter()
            try:
                return self._signer.sign(msg)
            finally:
                times["sign"] += time.perf_counter() - t0

    base = type(recording_cuda_provider(dev))

    class CreatorRecording(base):
        """The recording provider, also keeping each verify() lane (a
        creator check: one K2 launch of one lane), its verdict and its
        seconds."""

        def __init__(self, device):
            super().__init__(device)
            self.verify_lanes = []
            self.verify_s = 0.0

        def verify(self, key, signature, digest):
            t0 = time.perf_counter()
            ok = super().verify(key, signature, digest)
            self.verify_s += time.perf_counter() - t0
            self.verify_lanes.append((key, signature, digest, ok))
            return ok

    recorder = CreatorRecording(dev)
    bp = BatchingProvider(recorder)
    peers, pipes, committed, errors = [], [], [[], []], []
    sw = None
    try:
        for k in range(2):
            ch, endorser = endorsing_peer(en, k, str(root / f"peer{k}"), bp, dev,
                                          endorser_cls=TimedEndorser,
                                          signer=TimedSigner(en.net.endorsers[k]))
            peers.append((ch, endorser))
            pipes.append(CommitPipeline(ch, depth=PIPELINE_DEPTH, on_commit=(
                lambda b, f, k=k: committed[k].append(
                    (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH]))),
                on_error=lambda b, exc: errors.append(exc)))
        delivered = []
        solo = SoloChain(en.channel, signer=en.cn.orderer,
                         batch_config=BatchConfig(max_message_count=n_txs,
                                                  absolute_max_bytes=ENDORSE_MAX_BYTES,
                                                  preferred_max_bytes=ENDORSE_MAX_BYTES),
                         deliver=lambda b: delivered.append(wire.encode(fabric.BLOCK, b)),
                         genesis_block=en.genesis)
        if delivered != [wire.encode(fabric.BLOCK, en.genesis)]:
            raise AssertionError("endorse_config2: the orderer did not bootstrap from genesis")
        setup_s = time.perf_counter() - t_phase

        for table in (p256k.LAUNCHES, md.LAUNCHES):
            for key in table:
                table[key] = 0
        statuses, rounds_out, block_ms, sign_client_s = [], [], [], 0.0
        envs_by_round = []
        t_drive = time.perf_counter()
        for rnd in range(len(rounds)):
            t0 = time.perf_counter()
            props = en.proposals(rnd, n_txs)
            sign_client_s += time.perf_counter() - t0
            endorsed, refused_seen = [], 0
            for bundle, signed, refused in props:
                responses = []
                for k, (_, endorser) in enumerate(peers):
                    t0 = time.perf_counter()
                    resp = endorser.process_proposal(signed)
                    times["process"][k] += time.perf_counter() - t0
                    responses.append(resp)
                got = [(r["response"].get("status", 0), r["response"].get("message", ""))
                       for r in responses]
                want = ([(500, "access denied: The signature is invalid")] * 2 if refused
                        else [(200, "")] * 2)
                if got != want:
                    raise AssertionError(f"endorse_config2: round {rnd} proposal responses {got}")
                if refused:
                    refused_seen += 1
                    continue
                if responses[0]["payload"] != responses[1]["payload"]:
                    raise AssertionError("endorse_config2: the peers' response payloads differ")
                endorsed.append((bundle, responses))
            statuses.append({"endorsed": len(endorsed), "refused": refused_seen})
            envs = en.envelopes(rnd, endorsed, n_txs)
            envs_by_round.append(envs)
            # order: the n_txs-th envelope cuts the round's block
            before = len(delivered)
            for env in envs:
                solo.order(env)
            if len(delivered) != before + 1 or len(wire.decode(
                    fabric.BLOCK, delivered[-1])["data"]["data"]) != n_txs:
                raise AssertionError(f"endorse_config2: round {rnd} cut "
                                     f"{len(delivered) - before} blocks")
            t0 = time.perf_counter()
            for pipe in pipes:
                pipe.submit(wire.decode(fabric.BLOCK, delivered[-1]))
            if not all(pipe.drain(timeout=300) for pipe in pipes) or errors:
                raise AssertionError(f"endorse_config2: round {rnd} did not commit: {errors!r}")
            block_ms.append((time.perf_counter() - t0) * 1e3)
        drive_s = time.perf_counter() - t_drive
        n_props = sum(n_txs + r[2] for r in rounds)
        unpack = sum(times["process"]) - times["validate"] - times["simulate_endorse"]
        split = {"unpack": unpack, "validate_host": times["validate"] - recorder.verify_s,
                 "validate_k2_round_trip": recorder.verify_s,
                 "simulate": times["simulate_endorse"] - times["sign"], "sign": times["sign"]}
        launches = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                    "p256_key_tables": p256k.LAUNCHES["p256_key_tables"],
                    "p256_verify_limbs": p256k.LAUNCHES["p256_verify_limbs"],
                    **k5_launches(md)}
        stats = [pipe.stage_stats() for pipe in pipes]
        n_blocks = len(rounds)

        # --- the checks ---------------------------------------------------------
        want_codes = [en.codes(rnd, n_txs) for rnd in range(n_blocks)]
        if [f for f, _ in committed[0]] != want_codes or committed[0] != committed[1]:
            raise AssertionError("endorse_config2: filters or commit hashes differ between the "
                                 "peers or from the expected codes")
        creator_checks = len(recorder.verify_lanes)
        refused_lanes = [ok for _, _, _, ok in recorder.verify_lanes].count(False)
        if creator_checks != 2 * n_props or refused_lanes != 2 * sum(r[2] for r in rounds):
            raise AssertionError(f"endorse_config2: {creator_checks} creator checks, "
                                 f"{refused_lanes} refused")
        if (launches["p256_verify_bytes"] != creator_checks + len(recorder.records)
                or len(recorder.records) < n_blocks or launches["p256_key_tables"] < 1
                or launches["p256_verify_limbs"] or launches["mvcc_resolve"] != 2 * n_blocks
                or launches["mvcc_resolve_global"]):
            raise AssertionError(f"endorse_config2 launches: {launches}, "
                                 f"{len(recorder.records)} batch launches")
        # qscc through Org1's endorser, against the committed ledger
        ledger = peers[0][0].ledger
        conflicted = protoutil.unmarshal(fabric.CHANNEL_HEADER, wire.decode(
            fabric.PAYLOAD, envs_by_round[1][9]["payload"])["header"]["channel_header"])["tx_id"]
        qscc = {}
        for name, args in (("GetChainInfo", [b"GetChainInfo", en.channel.encode()]),
                           ("GetBlockByNumber", [b"GetBlockByNumber", en.channel.encode(), b"2"]),
                           ("GetTransactionByID", [b"GetTransactionByID", en.channel.encode(),
                                                   conflicted.encode()])):
            bundle = tb.create_proposal(en.net.client, en.channel, "qscc", args)
            resp = peers[0][1].process_proposal(tb.create_signed_proposal(bundle, en.net.client))
            if resp["response"].get("status") != 200:
                raise AssertionError(f"endorse_config2: qscc {name}: {resp['response']}")
            qscc[name] = resp["response"].get("payload", b"")
        info = wire.decode(fabric.BLOCKCHAIN_INFO, qscc["GetChainInfo"])
        last = ledger.block_store.get_block_by_number(n_blocks)
        block2 = wire.decode(fabric.BLOCK, qscc["GetBlockByNumber"])
        sent2 = wire.decode(fabric.BLOCK, delivered[2])
        pt = wire.decode(fabric.PROCESSED_TRANSACTION, qscc["GetTransactionByID"])
        if (info != {"height": n_blocks + 1,
                     "currentBlockHash": protoutil.block_header_hash(last["header"]),
                     "previousBlockHash": last["header"]["previous_hash"]}
                or (block2["header"], block2["data"]) != (sent2["header"], sent2["data"])
                or block2["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER] != want_codes[1]
                or block2["metadata"]["metadata"][fabric.COMMIT_HASH] != committed[0][1][1]
                or pt != {"transactionEnvelope": envs_by_round[1][9], "validationCode": 11}):
            raise AssertionError("endorse_config2: a qscc answer differs from the ledger")
        for pipe in pipes:
            pipe.stop()
        bp.stop()
        for ch, _ in peers:
            ch.ledger.close()

        # --- the same blocks stored serially, MVCC on the host -----------------
        ref, _ = endorsing_peer(en, 0, str(root / "reference"), CUDAProvider(device=dev), dev,
                                device_mvcc=False)
        t0 = time.perf_counter()
        ref_out = []
        for raw in delivered[1:]:
            b = wire.decode(fabric.BLOCK, raw)
            ref_out.append((ref.store_block(b).tobytes(),
                            b["metadata"]["metadata"][fabric.COMMIT_HASH]))
        ref_s = time.perf_counter() - t0
        ref.ledger.close()
        if ref_out != committed[0]:
            raise AssertionError("endorse_config2: the serial host-MVCC ledger differs")
        chains = {p: (root / p / f"{en.channel}.chain").read_bytes()
                  for p in ("peer0", "peer1", "reference")}
        rows = {p: ledger_rows(root / p / f"{en.channel}.state.db")
                for p in ("peer0", "peer1", "reference")}
        if len(set(chains.values())) != 1 or not rows["peer0"] == rows["peer1"] == rows[
                "reference"]:
            raise AssertionError("endorse_config2: .chain bytes or SQLite rows differ")
        if keep is not None:
            keep["endorse_config2"] = {
                "en": en, "envelopes": envs_by_round, "blocks": list(delivered),
                "committed": [list(committed[0]), list(committed[1])],
                "stored": [wire.encode(fabric.BLOCK, b) for b in
                           stored_blocks(root / "peer0" / f"{en.channel}.chain")],
                "rows": rows["peer0"]}

        # --- every K2 lane against SoftwareProvider(hostec_np) -----------------
        t0 = time.perf_counter()
        sw = factory.provider_from_config({**FACTORY_CONFIG, "Default": "SW"})
        if sw.describe_backend() != "sw:hostec_np":
            raise AssertionError(f"endorse_config2: host tier {sw.describe_backend()}")
        lanes = [(k, s, d, ok) for k, s, d, ok in recorder.verify_lanes]
        lanes += [lane for r in recorder.records
                  for lane in zip(r["keys"], r["sigs"], r["digests"], r["verdicts"])]
        held = []
        for off in range(0, len(lanes), K2_HOLD_CHUNK):
            chunk = lanes[off: off + K2_HOLD_CHUNK]
            held += sw.batch_verify([k for k, _, _, _ in chunk], [s for _, s, _, _ in chunk],
                                    [d for _, _, d, _ in chunk])
        if held != [ok for _, _, _, ok in lanes]:
            raise AssertionError("endorse_config2: K2 and hostec_np disagree on a lane")
        hold_s = time.perf_counter() - t0
    finally:
        for pipe in pipes:
            pipe.stop()
        bp.stop()
        hostec_np.shutdown_pool()
        hostec.shutdown_pool()
        shutil.rmtree(root, ignore_errors=True)

    n_endorsed = 2 * n_props
    emit({"phase": "endorse_config2", "blocks": n_blocks, "txs_per_block": n_txs,
          "rounds": [{"name": r[0], "proposals": n_txs + r[2], **s,
                      "codes": {str(c): want_codes[i].count(c) for c in sorted(set(
                          want_codes[i]))}}
                     for i, (r, s) in enumerate(zip(rounds, statuses))],
          "setup_seconds": setup_s, "drive_seconds": drive_s,
          "client_sign_seconds": sign_client_s,
          "ms_per_proposal": {k: v / n_endorsed * 1e3 for k, v in split.items()},
          "ms_per_proposal_total": sum(times["process"]) / n_endorsed * 1e3,
          "proposals_per_s_per_endorser": [n_props / t for t in times["process"]],
          "ms_per_block_pipeline": block_ms, "stage_stats": stats,
          "creator_checks": creator_checks, "creator_refused": refused_lanes,
          "k2_batch_launches": len(recorder.records),
          "k2_batch_lanes": [len(r["keys"]) for r in recorder.records],
          "qscc": {"height": info["height"], "block_2_equal": True,
                   "tx_validation_code": pt["validationCode"]},
          "serial_host_mvcc": {"seconds": ref_s, "equal": True},
          "k2_lanes_held": {"lanes": len(lanes), "seconds": hold_s},
          "peers_equal": True, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# The Raft orderer and block delivery: raft_config2
# ---------------------------------------------------------------------------

RAFT_TICK_S = 0.02  # the driver thread's tick: a 10-tick election timeout is 0.2-0.4 s
RAFT_WAIT_S = 600.0  # the longest any wait of the phase may take before it fails
RAFT_FLIPPED = 8  # envelopes with a flipped envelope signature (FORBIDDEN, never ordered)
RAFT_OUTSIDERS = 4  # envelopes signed by an identity outside the channel (FORBIDDEN)


class RaftNet:
    """raft_config2's ordering service in one process: a port Registrar per
    consenter (raft ids 1..n, each with its own orderer-org signer, all
    bundles over `provider`) joined to one etcdraft genesis; their raft
    messages carried by in-process queues that one driver thread drains,
    ticking every live node each RAFT_TICK_S; per node a BroadcastHandler
    whose cluster client forwards an envelope the node cannot order to the
    leader's handler (forwarded=True), a DeliverHandler for clients whose
    sessions must satisfy `readers` (the channel's Readers policy), and
    one for the cluster (orderer to orderer, no policy: the cluster's
    transport authenticates its members). A partitioned node neither ticks
    nor sends nor receives, its endpoints refuse to connect, and a session
    it serves ends; `restart` reopens a node's Registrar on its ledger and
    WAL, and a session the old one still serves breaks with a
    ConnectionError, as its stream would. Every wait is woken by a block
    write, a partition, a restart or `stop`."""

    def __init__(self, genesis: dict, signers, provider, root, readers, channel: str):
        import collections
        import threading

        self.genesis = genesis
        self.signers = signers
        self.provider = provider
        self.root = root
        self.readers = readers
        self.channel = channel
        self.n = len(signers)
        self.queues = {i: collections.deque() for i in range(1, self.n + 1)}
        self.regs, self.handlers, self.delivers, self.cluster_delivers = {}, {}, {}, {}
        self.partitioned = set()
        self.incarnation = {}  # node -> how many times it was started
        self.written_at = {}  # (node, block number) -> perf_counter when written
        self.sessions = 0  # client deliver sessions opened (each a Readers check)
        self.forwards = 0
        self._cv = threading.Condition()
        self._closed = False
        for i in range(1, self.n + 1):
            self.start_node(i)
        self._thread = threading.Thread(target=self._drive, name="raft-driver", daemon=True)
        self._thread.start()

    # -- nodes ---------------------------------------------------------------
    def start_node(self, i: int) -> None:
        from fabric_tpu_torch.deliver.server import DeliverHandler
        from fabric_tpu_torch.orderer.broadcast import BroadcastHandler
        from fabric_tpu_torch.orderer.multichannel import Registrar

        reg = Registrar(str(self.root / f"orderer{i}"), signer=self.signers[i - 1],
                        raft_node_id=i, provider=self.provider,
                        raft_transport_factory=lambda channel, frm: (
                            lambda to, msg: self._send(frm, to, msg)))
        reg.on_block(lambda channel, block, i=i: self._written(i, block))
        reg.join_channel(self.genesis)
        with self._cv:
            gen = self.incarnation[i] = self.incarnation.get(i, 0) + 1
            self.regs[i] = reg
            self.handlers[i] = BroadcastHandler(reg, cluster_client=self)
            self.delivers[i] = DeliverHandler(self.source(i, reg, gen),
                                              policy_checker=self._readers,
                                              wait_timeout=RAFT_WAIT_S)
            self.cluster_delivers[i] = DeliverHandler(self.source(i, reg, gen),
                                                      wait_timeout=RAFT_WAIT_S)
            self._cv.notify_all()

    def _readers(self, channel, sd):
        with self._cv:
            self.sessions += 1
        self.readers(channel, sd)

    def source(self, i, reg, gen):
        from fabric_tpu_torch.deliver.server import BlockSource

        def lookup(channel):
            support = reg.get_chain(channel) or reg.followers.get(channel)
            if support is None:
                return None

            def get_block(n):
                self._alive(i, gen)
                try:
                    return support.get_block(n)
                except Exception:
                    self._alive(i, gen)  # its store closed under it by a restart
                    raise

            return BlockSource(get_block, lambda: support.height,
                               lambda n, timeout: self._wait(i, gen, support, n, timeout))

        return lookup

    def _alive(self, i, gen) -> None:
        if self.incarnation[i] != gen:
            raise ConnectionError(f"orderer {i} restarted")

    def _wait(self, i, gen, support, n, timeout) -> bool:
        with self._cv:
            self._cv.wait_for(lambda: support.height > n or i in self.partitioned
                              or self._closed or self.incarnation[i] != gen, timeout)
            self._alive(i, gen)
            return support.height > n and i not in self.partitioned and not self._closed

    def _written(self, i, block) -> None:
        import time as _time

        with self._cv:
            self.written_at[(i, block["header"].get("number", 0))] = _time.perf_counter()
            self._cv.notify_all()

    def chain(self, i):
        support = self.regs[i].get_chain(self.channel)
        return support.chain if support is not None else None

    def height(self, i) -> int:
        return self.chain(i).height

    # -- transport and the driver thread --------------------------------------
    def _send(self, frm, to, msg) -> None:
        with self._cv:
            if frm in self.partitioned or to in self.partitioned or to not in self.queues:
                return
            self.queues[to].append(msg)
            self._cv.notify_all()

    def forward_submit(self, channel_id, env, leader_id):
        from fabric_tpu_torch.protos import fabric

        if leader_id in self.partitioned:
            return fabric.SERVICE_UNAVAILABLE, f"leader {leader_id} unreachable"
        self.forwards += 1
        return self.handlers[leader_id].process_message(env, forwarded=True)

    def _drive(self) -> None:
        import time as _time

        next_tick = _time.perf_counter()
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._closed or any(
                    q for i, q in self.queues.items() if i not in self.partitioned),
                    max(0.0, next_tick - _time.perf_counter()))
                if self._closed:
                    return
                live = [i for i in sorted(self.regs) if i not in self.partitioned]
            if _time.perf_counter() >= next_tick:
                for i in live:
                    self.chain(i).tick()
                next_tick = _time.perf_counter() + RAFT_TICK_S
            for i in live:
                q = self.queues[i]
                while q:
                    msg = q.popleft()
                    if i not in self.partitioned:
                        self.chain(i).step(msg)

    # -- the phase's moves -----------------------------------------------------
    def leader(self, exclude=()):
        for i in sorted(self.regs):
            if i in self.partitioned or i in exclude:
                continue
            chain = self.chain(i)
            if chain is not None and chain.node.role == "leader":
                return i
        return None

    def wait(self, pred, what: str, timeout=RAFT_WAIT_S):
        with self._cv:
            if not self._cv.wait_for(pred, timeout):
                raise AssertionError(f"raft_config2: timed out waiting for {what}")

    def wait_leader(self, exclude=()) -> int:
        self.wait(lambda: self.leader(exclude) is not None, "a leader")
        return self.leader(exclude)

    def wait_height(self, ids, height: int) -> None:
        self.wait(lambda: all(self.height(i) >= height for i in ids),
                  f"height {height} on {sorted(ids)}")

    def partition(self, i) -> None:
        with self._cv:
            self.partitioned.add(i)
            self.queues[i].clear()
            self._cv.notify_all()

    def restart(self, i) -> None:
        """Node i (partitioned) stops and starts again from its block store
        and WAL; healed afterwards by `heal`."""
        with self._cv:
            self.incarnation[i] += 1  # the old one's sessions break from here
            self._cv.notify_all()
        chain = self.chain(i)
        chain.wal.close()
        chain.block_store.close()
        self.start_node(i)

    def heal(self) -> None:
        with self._cv:
            self.partitioned.clear()
            self._cv.notify_all()

    def endpoint(self, i, cluster=False):
        """Node i's deliver endpoint for a BlockDeliverer: refuses to connect
        while node i is partitioned."""
        def serve(env):
            if i in self.partitioned:
                raise ConnectionError(f"orderer {i} unreachable")
            handler = self.cluster_delivers[i] if cluster else self.delivers[i]
            return handler.deliver_blocks(env)

        return serve

    def stop(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        for reg in self.regs.values():
            for support in reg.chains.values():
                support.chain.wal.close()
                support.chain.block_store.close()


def raft_phase(torch, np, dev, kept: dict) -> dict:
    """raft_config2: endorse_config2's envelopes ordered by a three-node
    etcdraft cluster of the port (`RaftNet`) and delivered to two fresh
    peers on the card. The genesis is endorse_config2's (`EndorseNet`: three
    consenters, BatchSize of its round's txs); each consenter is a
    Registrar with its own orderer-org signer. Traffic: every envelope that
    endorse_config2 ordered, round by round, broadcast through a consenter
    that is not the leader: its SigFilter (the channel's Writers, K2) admits
    it and its BroadcastHandler forwards it to the leader's, whose SigFilter
    checks it again before the leader's RaftChain cuts and proposes it; 8
    envelopes with a flipped signature and 4 signed by an identity outside
    the channel answered FORBIDDEN at the first consenter. After block 1
    is written everywhere the leader is partitioned; the other two elect a
    leader and order blocks 2 and 3; the old leader restarts from its
    block store and WAL, is healed and catches up. Two fresh peers
    (`endorsing_peer` on the genesis, CommitPipelines over one
    BatchingProvider(CUDAProvider): the orderer signature, K2, the key combs
    and K5) pull through BlockDeliverers whose endpoints are the three
    consenters' DeliverHandlers, the partitioned leader first, each session
    authorized by the channel's Readers policy (K2). A fourth orderer joins
    the genesis as a non-consenter and replicates through the cluster's
    deliver (FollowerChain). DiscoveryService over the two peers answers
    peers, config and endorsers("benchcc"), each client authorized through
    K2, a stranger refused. Checks (no difference allowed): every block's
    header and data equal the solo chain's; every consenter's and the
    follower's blocks agree in header, data and consenter ids, and each
    consenter's signature verifies; both peers' filters, commit hashes,
    stored headers, data, filters, commit hashes and SQLite rows equal
    endorse_config2's; every K2 lane of the phase equal to
    SoftwareProvider(hostec_np); K2 launched at every SigFilter, deliver
    session and block, the key combs, K5 once a block on each peer.
    Returns the phase's launches of K2, the key combs and K5."""
    import random
    import shutil
    import threading
    from pathlib import Path

    from fabric_tpu_torch.channelconfig.bundle import bundle_from_genesis_block
    from fabric_tpu_torch.common.retry import RetryPolicy
    from fabric_tpu_torch.crypto import factory, hostec, hostec_np
    from fabric_tpu_torch.deliver.client import BlockDeliverer
    from fabric_tpu_torch.discovery import DiscoveryService, PeerInfo
    from fabric_tpu_torch.discovery.service import DiscoveryError
    from fabric_tpu_torch.ledger import mvcc_device as md
    from fabric_tpu_torch.ops import p256_kernel as p256k
    from fabric_tpu_torch.orderer import broadcast as bcast
    from fabric_tpu_torch.orderer import msgprocessor, raft_chain
    from fabric_tpu_torch.orderer.blockwriter import block_signature_verifier
    from fabric_tpu_torch.orderer.multichannel import Registrar
    from fabric_tpu_torch.parallel.batcher import BatchingProvider
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.policy.manager import SignedData
    from fabric_tpu_torch.protos import configtx as cfgpb
    from fabric_tpu_torch.protos import fabric, protoutil, wire

    t_phase = time.perf_counter()
    en = kept["en"]
    rounds = kept["envelopes"]
    n_blocks = len(rounds)
    solo = [wire.decode(fabric.BLOCK, raw) for raw in kept["blocks"]]
    genesis = en.genesis
    channel = en.channel
    signers = en.consenter_signers()
    root = Path(__file__).resolve().parent / "build" / "smoke_raft"
    shutil.rmtree(root, ignore_errors=True)
    # one recording provider a role, so each K2 launch is told apart:
    # the consenters' SigFilters, the client deliver sessions' Readers
    # checks, the peers (orderer signatures and validation), discovery
    roles = ("sigfilter", "deliver", "peers", "discovery")
    recorders = {r: recording_cuda_provider(dev) for r in roles}
    bps = {r: BatchingProvider(recorders[r]) for r in roles}
    readers_bundle = bundle_from_genesis_block(genesis, bps["deliver"])

    def readers(channel_id, sd):
        policy, _ = readers_bundle.policy_manager.get_policy("/Channel/Readers")
        policy.evaluate_signed_data([sd])

    # the host split of a broadcast envelope: the handler's header parse
    # (its only use of protoutil), SigFilter, RaftChain.order, and the whole
    times = {"unpack": 0.0, "sigfilter": 0.0, "propose": 0.0, "total": 0.0}
    proposed_at = []
    sig_apply, order, propose_batch = (msgprocessor.SigFilter.apply, raft_chain.RaftChain.order,
                                       raft_chain.RaftChain._propose_batch)

    def timed_sig(self, env):
        t0 = time.perf_counter()
        try:
            return sig_apply(self, env)
        finally:
            times["sigfilter"] += time.perf_counter() - t0

    def timed_order(self, env):
        t0 = time.perf_counter()
        try:
            return order(self, env)
        finally:
            times["propose"] += time.perf_counter() - t0

    class TimedUnpack:
        def __getattr__(self, name):
            return getattr(protoutil, name)

        @staticmethod
        def unmarshal_as(*args):
            t0 = time.perf_counter()
            try:
                return protoutil.unmarshal_as(*args)
            finally:
                times["unpack"] += time.perf_counter() - t0

    def stamped_propose(self, batch, is_config=False):
        proposed_at.append(time.perf_counter())
        return propose_batch(self, batch, is_config)

    net, peers, pipes, deliverers, threads, follower_reg = None, [], [], [], [], None
    errors, committed = [], [[], []]
    commit_at = [{}, {}]
    sw = None
    try:
        bcast.protoutil = TimedUnpack()
        msgprocessor.SigFilter.apply = timed_sig
        raft_chain.RaftChain.order = timed_order
        raft_chain.RaftChain._propose_batch = stamped_propose
        net = RaftNet(genesis, signers[:RAFT_CONSENTERS], bps["sigfilter"], root, readers,
                      channel)
        ids = list(range(1, RAFT_CONSENTERS + 1))
        first_leader = net.wait_leader()
        for k in range(2):
            ch, _ = endorsing_peer(en, k, str(root / f"peer{k}"), bps["peers"], dev)
            peers.append(ch)
            pipes.append(CommitPipeline(ch, depth=PIPELINE_DEPTH, on_commit=(
                lambda b, f, k=k: (committed[k].append(
                    (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH])),
                    commit_at[k].__setitem__(b["header"]["number"], time.perf_counter()))),
                on_error=lambda b, exc: errors.append(exc)))
        setup_s = time.perf_counter() - t_phase

        for table in (p256k.LAUNCHES, md.LAUNCHES):
            for key in table:
                table[key] = 0
        t_drive = time.perf_counter()
        # the peers pull through the consenters, the leader first
        order_ids = [first_leader] + [i for i in ids if i != first_leader]
        got = [[], []]
        for k in range(2):
            d = BlockDeliverer(channel, [net.endpoint(i) for i in order_ids],
                               on_block=lambda b, k=k: (got[k].append(b["header"]["number"]),
                                                        pipes[k].submit(b)),
                               next_block=lambda k=k: len(got[k]) + 1,
                               signer=en.net.endorsers[k],
                               retry_policy=RetryPolicy(base_s=0.05, multiplier=1.2, cap_s=1.0,
                                                        deadline_s=RAFT_WAIT_S))
            deliverers.append(d)
            threads.append(threading.Thread(target=d.run, kwargs={"max_blocks": n_blocks},
                                            name=f"deliver-peer{k}", daemon=True))
        for t in threads:
            t.start()
        # the fourth orderer follows the cluster through its deliver
        by_address = {f"{host}:{port}": i
                      for i, (host, port, _, _) in enumerate(en.consenters, start=1)}
        follower_reg = Registrar(str(root / "orderer4"), signer=signers[RAFT_CONSENTERS],
                                 raft_node_id=RAFT_CONSENTERS + 1, provider=bps["sigfilter"],
                                 follower_endpoint_factory=lambda addrs: [
                                     net.endpoint(by_address[a], cluster=True)
                                     for a in addrs if a in by_address])
        follower = follower_reg.join_channel(genesis)
        if type(follower).__name__ != "FollowerChain":
            raise AssertionError("raft_config2: the fourth orderer did not join as a follower")

        # -- broadcast ------------------------------------------------------------
        statuses = {"success": 0, "forbidden": 0}
        rng = random.Random(f"raft {channel}")
        bad = []
        for env in rng.sample(rounds[0], RAFT_FLIPPED):
            sig = env["signature"]
            bad.append({**env, "signature": sig[:-1] + bytes([sig[-1] ^ 0x01])})
        outsider = en.net.stranger
        for j in range(RAFT_OUTSIDERS):
            payload = wire.decode(fabric.PAYLOAD, rounds[0][j]["payload"])
            payload["header"]["signature_header"] = wire.encode(
                fabric.SIGNATURE_HEADER, protoutil.make_signature_header(
                    outsider.serialize(), outsider.new_nonce()))
            raw = wire.encode(fabric.PAYLOAD, payload)
            bad.append({"payload": raw, "signature": outsider.sign(raw)})

        def broadcast(node, envs, want):
            handler = net.handlers[node]
            for env in envs:
                t0 = time.perf_counter()
                status, info = handler.process_message(env)
                times["total"] += time.perf_counter() - t0
                if status != want:
                    raise AssertionError(f"raft_config2: broadcast answered {status} {info!r}")
                statuses["success" if want == fabric.SUCCESS else "forbidden"] += 1

        via = next(i for i in ids if i != first_leader)
        broadcast(via, bad, fabric.FORBIDDEN)
        broadcast(via, rounds[0], fabric.SUCCESS)
        net.wait_height(ids, 2)
        # -- failover: the leader is cut off; the other two carry on -------------
        t0 = time.perf_counter()
        net.partition(first_leader)
        new_leader = net.wait_leader(exclude={first_leader})
        failover_s = time.perf_counter() - t0
        live = [i for i in ids if i != first_leader]
        via = next(i for i in live if i != new_leader)
        for rnd in range(1, n_blocks):
            broadcast(via, rounds[rnd], fabric.SUCCESS)
        net.wait_height(live, n_blocks + 1)
        # -- the old leader restarts from its WAL and catches up ------------------
        t0 = time.perf_counter()
        net.restart(first_leader)
        net.heal()
        net.wait_height(ids, n_blocks + 1)
        catch_up_s = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=RAFT_WAIT_S)
        if any(t.is_alive() for t in threads) or got != [list(range(1, n_blocks + 1))] * 2:
            raise AssertionError(f"raft_config2: the peers pulled {got}")
        if not all(pipe.drain(timeout=RAFT_WAIT_S) for pipe in pipes) or errors:
            raise AssertionError(f"raft_config2: the peers did not commit: {errors!r}")
        net.wait(lambda: follower.height == n_blocks + 1, "the follower")
        # -- discovery over the two peers --------------------------------------
        disc_bundle = bundle_from_genesis_block(genesis, bps["discovery"])
        infos = [PeerInfo("Org1MSP", "peer0.org1.bench:7051", peers[0].ledger.height,
                          ("benchcc",)),
                 PeerInfo("Org2MSP", "peer0.org2.bench:7051", peers[1].ledger.height,
                          ("benchcc",))]
        svc = DiscoveryService(lambda ch: infos if ch == channel else [],
                               lambda ch: disc_bundle if ch == channel else None,
                               lambda cc, ch: en.net.policy if cc == "benchcc" else None)
        discovery = {}
        for who, signer in (("org1", en.net.client), ("org2", en.cn.clients[1]),
                            ("org3", en.cn.clients[2])):
            sd = SignedData(b"discover", signer.serialize(), signer.sign(b"discover"))
            discovery[who] = {
                "peers": [p.endpoint for p in svc.peers(channel, sd)],
                "config": svc.config(channel, sd),
                "layouts": svc.endorsers(channel, "benchcc", sd).layouts}
        stranger = SignedData(b"discover", outsider.serialize(), outsider.sign(b"discover"))
        try:
            svc.peers(channel, stranger)
            raise AssertionError("raft_config2: discovery answered a stranger")
        except DiscoveryError:
            pass
        drive_s = time.perf_counter() - t_drive
        launches = {"p256_verify_bytes": p256k.LAUNCHES["p256_verify_bytes"],
                    "p256_key_tables": p256k.LAUNCHES["p256_key_tables"],
                    "p256_verify_limbs": p256k.LAUNCHES["p256_verify_limbs"],
                    **k5_launches(md)}
        k2_by_role = {r: len(recorders[r].records) for r in roles}
        stats = [pipe.stage_stats() for pipe in pipes]
        for pipe in pipes:
            pipe.stop()

        # --- the checks ---------------------------------------------------------
        n_ordered = sum(len(r) for r in rounds)
        if statuses != {"success": n_ordered, "forbidden": RAFT_FLIPPED + RAFT_OUTSIDERS}:
            raise AssertionError(f"raft_config2: broadcast statuses {statuses}")
        ledgers = {i: [net.chain(i).get_block(n) for n in range(n_blocks + 1)] for i in ids}
        followed = [follower.get_block(n) for n in range(n_blocks + 1)]
        for n in range(1, n_blocks + 1):
            want = (solo[n]["header"], solo[n]["data"])
            for blocks in list(ledgers.values()) + [followed]:
                b = blocks[n]
                if (b["header"], b["data"]) != want:
                    raise AssertionError(f"raft_config2: block {n} differs from the solo chain's")
                if (b["metadata"]["metadata"][fabric.ORDERER_METADATA]
                        != ledgers[1][n]["metadata"]["metadata"][fabric.ORDERER_METADATA]):
                    raise AssertionError(f"raft_config2: block {n}'s consenter ids differ")
            if not any(wire.encode(fabric.BLOCK, followed[n]) == wire.encode(
                    fabric.BLOCK, blocks[n]) for blocks in ledgers.values()):
                raise AssertionError(f"raft_config2: the follower's block {n} is no consenter's")
        genesis_raw = wire.encode(fabric.BLOCK, genesis)
        stamped = {wire.encode(fabric.BLOCK, ledgers[i][0]) for i in ids}
        if len(stamped) != 1 or wire.encode(fabric.BLOCK, followed[0]) != genesis_raw:
            raise AssertionError("raft_config2: the genesis blocks differ")
        ids_meta = cfgpb.RAFT_BLOCK_METADATA
        consenter_ids = wire.decode(ids_meta, ledgers[1][1]["metadata"]["metadata"][
            fabric.ORDERER_METADATA])
        if consenter_ids.get("consenter_ids") != ids:
            raise AssertionError(f"raft_config2: consenter ids {consenter_ids}")
        check_rec = recording_cuda_provider(dev)
        check_bundle = bundle_from_genesis_block(genesis, check_rec)
        verify = block_signature_verifier(lambda: check_bundle)
        if not all(verify(ledgers[i][n]) for i in ids for n in range(1, n_blocks + 1)):
            raise AssertionError("raft_config2: a consenter's block signature does not verify")
        if committed[0] != committed[1] or committed[0] != kept["committed"][0]:
            raise AssertionError("raft_config2: the peers' filters or commit hashes differ "
                                 "from endorse_config2's")
        for ch in peers:
            ch.ledger.close()
        rows = {k: ledger_rows(root / f"peer{k}" / f"{channel}.state.db") for k in range(2)}
        stored = {k: stored_blocks(root / f"peer{k}" / f"{channel}.chain") for k in range(2)}
        want_stored = [wire.decode(fabric.BLOCK, raw) for raw in kept["stored"]]

        def public(b):
            m = b["metadata"]["metadata"]
            return b["header"], b["data"], m[fabric.TRANSACTIONS_FILTER], m[fabric.COMMIT_HASH]

        for k in range(2):
            if rows[k] != kept["rows"] or [public(b) for b in stored[k][1:]] != [
                    public(b) for b in want_stored[1:]] or wire.encode(
                    fabric.BLOCK, stored[k][0]) != kept["stored"][0]:
                raise AssertionError(f"raft_config2: peer {k}'s ledger differs from "
                                     "endorse_config2's")
        want_layouts = [{"G0": 1, "G1": 1}]
        for who, answer in discovery.items():
            if (answer["peers"] != ["peer0.org1.bench:7051", "peer0.org2.bench:7051"]
                    or answer["layouts"] != want_layouts
                    or answer["config"]["msps"] != ["OrdererMSP", "Org1MSP", "Org2MSP",
                                                    "Org3MSP"]):
                raise AssertionError(f"raft_config2: discovery answered {who}: {answer}")
        # launches: K2 at every SigFilter (twice an ordered envelope: the
        # consenter it reached and the leader), at every flipped one, at
        # each client deliver session, at each block on each peer
        sessions = net.sessions
        if (launches["p256_verify_bytes"] != sum(k2_by_role.values())
                or k2_by_role["sigfilter"] < 2 * n_ordered + RAFT_FLIPPED
                or sessions < 3 or k2_by_role["deliver"] < sessions
                or k2_by_role["peers"] < n_blocks or k2_by_role["discovery"] < 3
                or launches["p256_key_tables"] < 1 or launches["p256_verify_limbs"]
                or launches["mvcc_resolve"] != 2 * n_blocks or launches["mvcc_resolve_global"]):
            raise AssertionError(f"raft_config2 launches: {launches}, by role {k2_by_role}, "
                                 f"{sessions} sessions")
        for bp in bps.values():
            bp.stop()

        # --- every K2 lane against SoftwareProvider(hostec_np) -----------------
        t0 = time.perf_counter()
        sw = factory.provider_from_config({**FACTORY_CONFIG, "Default": "SW"})
        if sw.describe_backend() != "sw:hostec_np":
            raise AssertionError(f"raft_config2: host tier {sw.describe_backend()}")
        lanes = [lane for rec in list(recorders.values()) + [check_rec] for r in rec.records
                 for lane in zip(r["keys"], r["sigs"], r["digests"], r["verdicts"])]
        held = []
        for off in range(0, len(lanes), K2_HOLD_CHUNK):
            chunk = lanes[off: off + K2_HOLD_CHUNK]
            held += sw.batch_verify([k for k, _, _, _ in chunk], [s for _, s, _, _ in chunk],
                                    [d for _, _, d, _ in chunk])
        if held != [ok for _, _, _, ok in lanes]:
            raise AssertionError("raft_config2: K2 and hostec_np disagree on a lane")
        refused_lanes = [ok for _, _, _, ok in lanes].count(False)
        hold_s = time.perf_counter() - t0
    finally:
        bcast.protoutil = protoutil
        msgprocessor.SigFilter.apply = sig_apply
        raft_chain.RaftChain.order = order
        raft_chain.RaftChain._propose_batch = propose_batch
        for d in deliverers:
            d.stop()
        if net is not None:
            net.stop()
        for t in threads:
            t.join(timeout=30)
        if follower_reg is not None:
            for f in list(follower_reg.followers.values()):
                f.stop()
        for pipe in pipes:
            pipe.stop()
        for bp in bps.values():
            bp.stop()
        for ch in peers:
            ch.ledger.close()
        hostec_np.shutdown_pool()
        hostec.shutdown_pool()
        shutil.rmtree(root, ignore_errors=True)

    n_env = sum(len(r) for r in rounds)
    block_ms = []
    for n in range(1, n_blocks + 1):
        t_cut = proposed_at[n - 1]
        # the consenters live when the block was cut (the partitioned leader
        # writes blocks 2 on only when it is restarted)
        writers = [t for (i, b), t in net.written_at.items()
                   if b == n and i in ids and (n == 1 or i != first_leader)]
        block_ms.append({"block": n,
                         "consenters_ms": (max(writers) - t_cut) * 1e3,
                         "peers_ms": [(commit_at[k][n] - t_cut) * 1e3 for k in range(2)]})
    # what the three timed steps leave of the handler's time: classify, the
    # expiration and size filters, the forwarding hop and the calls
    other = times["total"] - times["unpack"] - times["sigfilter"] - times["propose"]
    emit({"phase": "raft_config2", "consenters": RAFT_CONSENTERS, "blocks": n_blocks,
          "txs_per_block": [len(r) for r in rounds], "tick_s": RAFT_TICK_S,
          "broadcast": {**statuses, "forwarded": net.forwards,
                        "flipped": RAFT_FLIPPED, "outsiders": RAFT_OUTSIDERS},
          "setup_seconds": setup_s, "drive_seconds": drive_s,
          "ms_per_envelope": {"unpack": times["unpack"] / n_env * 1e3,
                              "sigfilter": times["sigfilter"] / n_env * 1e3,
                              "propose": times["propose"] / n_env * 1e3,
                              "classify_filters_forward": other / n_env * 1e3},
          "ms_per_envelope_broadcast": times["total"] / n_env * 1e3,
          "ms_per_block_cut_to_commit": block_ms,
          "failover_seconds": failover_s, "leaders": [first_leader, new_leader],
          "restart_catch_up_seconds": catch_up_s,
          "deliver_sessions": sessions, "follower_height": n_blocks + 1,
          "discovery": {"clients": sorted(discovery), "layouts": want_layouts,
                        "stranger": "refused"},
          "stage_stats": stats,
          "k2_launches_by_role": k2_by_role,
          "k2_lanes_held": {"lanes": len(lanes), "refused": refused_lanes, "seconds": hold_s},
          "equal": {"solo_blocks": True, "consenters": True, "follower": True,
                    "peers_vs_endorse_config2": True},
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    return launches


# the repetitions device_ms takes for K5 and K6 (20) and for K7 (50)
FLOOR_REPS = (20, 50)


def floor_ms(torch, cudalib, dev, threads: int = 1, shared_bytes: int = 0) -> dict:
    """What one launch costs between two events on this card: device_ms of
    a kernel that does nothing (csrc/policy_eval.cu launch_floor; one block
    of `threads` threads and `shared_bytes` of dynamic shared memory), at
    each of FLOOR_REPS, after a warm-up launch. A measurement, not a
    feature: no wrapper launches it."""
    import ctypes

    lib = cudalib.load("policy_eval")
    lib.launch_floor_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.launch_floor_launch.restype = ctypes.c_int

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lib.launch_floor_launch(threads, shared_bytes, stream) != 0:
            raise RuntimeError("launch_floor failed to launch")

    launch()
    torch.cuda.synchronize()
    return {reps: device_ms(torch, launch, reps) for reps in FLOOR_REPS}


def module_probe(names=("grpc", "yaml")) -> dict:
    """Whether each module imports on this machine and its version, each in a
    child process: the smoke itself imports neither."""
    import subprocess

    out = {}
    for name in names:
        proc = subprocess.run(
            [sys.executable, "-c", f"import {name}; print(getattr({name}, '__version__', ''))"],
            capture_output=True, text=True, timeout=120)
        err = proc.stderr.strip().splitlines()
        out[name] = {"imports": proc.returncode == 0, "version": proc.stdout.strip() or None,
                     "error": err[-1] if proc.returncode and err else None}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    import numpy as np

    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.utils import native

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # --- build: one nvcc per source and g++ for the native host runtime,
    # all started together ---------------------------------------------------
    t0 = time.perf_counter()
    sources = ("p256_verify", "mvcc_resolve", "bn256", "policy_eval")

    def timed_native_build() -> float:
        t = time.perf_counter()
        native.build()
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(sources) + 1) as pool:
        native_build = pool.submit(timed_native_build)
        list(pool.map(cudalib.build, sources))
        native_build_s = native_build.result()
    for name in sources:
        cudalib.load(name)
    native.load()
    by_function = {}
    for name in sources:
        by_function.update(ptxas_by_function(cudalib.ptxas_report(name)))
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "native_build_seconds": native_build_s,
        "ptxas": {name: [ln for ln in cudalib.ptxas_report(name).splitlines()
                         if "registers" in ln or "spill" in ln or "stack" in ln]
                  for name in sources},
        # the kernels redesigned last (K5's and K7's shared routes), the two
        # instances of K7's global route and K6's shared route beside them:
        # registers, stack, spills, shared memory
        "redesigned": {fn: lines for fn, lines in by_function.items()
                       if fn in ("mvcc_resolve", "policy_eval", "mvcc_resolve_resident")
                       or "policy_eval_kernel" in fn},
    })

    # whether the card's machine has what the grpc and yaml modules of the
    # JAX package need, for the slices that port them
    emit({"phase": "modules", **module_probe()})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    imad_rate = IMAD_PER_SM_PER_CLOCK * sms * clock_hz
    chain = {}
    kernels, k2_block, der_sets = p256_phases(torch, np, dev, imad_rate, keep=chain)
    # --- MVCC: kernel vs plain, config #4, the resident chain --------------
    kernels += mvcc_phases(torch, np, dev)
    # --- Idemix: kernel vs plain, config #3, the mixed mask -----------------
    kernels += idemix_phases(torch, np, dev, imad_rate, keep=chain)
    # --- Block validation of config #2, K7 ----------------------------------
    blocks, k7 = validator_phases(torch, np, dev, k2_block)
    kernels += k7
    # --- The native host runtime against the Python routes -----------------
    native_phase(np, native_build_s, der_sets, blocks)
    # --- Config #5: four channels, one K1 launch a validate ----------------
    k1_config5 = multichannel_phase(torch, np, dev, imad_rate, keep=chain)
    next(k for k in kernels if k["name"] == "p256_verify_limbs")["config5"] = k1_config5
    # --- The peer's commit path: the pipelined chain, four channels --------
    pipeline_launches = pipeline_phases(torch, np, dev, keep=chain)
    # --- Join by snapshot: a peer joined from a 1M-key state commits the rest -
    snapshot_launches = snapshot_phase(torch, np, dev, chain["net"], chain["raws"])
    # --- Channel configuration: a config update that adds Org4 -------------
    config_launches = config_phase(torch, np, dev, chain["net"], chain["raws"])
    # --- The BCCSP factory and the host ladder ------------------------------
    factory_launches = factory_phase(torch, np, dev, chain["net"], chain["k2_records"],
                                     chain["idemix_sets"], keep=chain)
    # --- The serve sidecar: config #2 verified through sidecars -------------
    serve_launches = serve_phase(torch, np, dev, chain["net"], chain["raws"], chain["memo"],
                                 chain["pipeline_config2"])
    for name in ("p256_verify_bytes", "p256_key_tables", "mvcc_resolve"):
        row = next(k for k in kernels if k["name"] == name)
        row["pipeline_config2"] = {"launches": pipeline_launches[name]}
        row["snapshot_config2"] = {"launches": snapshot_launches[name]}
        row["config_update_config2"] = {"launches": config_launches[name]}
    for name in ("p256_verify_bytes", "p256_key_tables", "bn256_msm", "ate2_unity"):
        row = next(k for k in kernels if k["name"] == name)
        row["factory_config2"] = {"launches": factory_launches[name]}
    for name in ("p256_verify_bytes", "p256_key_tables", "p256_verify_limbs"):
        row = next(k for k in kernels if k["name"] == name)
        row["serve_config2"] = {"launches": {who: serve_launches[who][name]
                                             for who in ("server", "rescue", "in_process")}}
    next(k for k in kernels if k["name"] == "mvcc_resolve")["serve_config2"] = {
        "launches": serve_launches["mvcc_resolve"]}
    # --- The Idemix MSP: idemixgen, IdemixMSP, the proofs on K4/K3 ---------
    msp_launches = idemix_msp_phase(torch, np, dev)
    # --- The multi-device wrappers over the card listed 4 times ------------
    mesh_launches = mesh_sharded_phase(torch, np, dev, {
        "headline": chain["headline"], "limb": chain["limb"], "net": chain["net"],
        "config2": blocks["config2"], "config5": chain["config5"],
        "config3": chain["idemix_sets"][f"config3_{IDEMIX_SIZES[-1]}"]})
    for name in ("bn256_msm", "ate2_unity"):
        row = next(k for k in kernels if k["name"] == name)
        row["idemix_msp"] = {"launches": msp_launches[name]}
    for name in ("p256_verify_limbs", "p256_verify_bytes", "p256_key_tables", "ate2_unity"):
        row = next(k for k in kernels if k["name"] == name)
        row["mesh_sharded"] = {"launches": mesh_launches[name]}
    # --- The endorsement side and the solo orderer: proposals to blocks -----
    endorse_launches = endorse_phase(torch, np, dev, keep=chain)
    # --- The Raft orderer and block delivery: the same envelopes, 3 consenters -
    raft_launches = raft_phase(torch, np, dev, chain["endorse_config2"])
    for name in ("p256_verify_bytes", "p256_key_tables", "mvcc_resolve"):
        row = next(k for k in kernels if k["name"] == name)
        row["endorse_config2"] = {"launches": endorse_launches[name]}
        row["raft_config2"] = {"launches": raft_launches[name]}
    floor = floor_ms(torch, cudalib, dev)
    emit({"phase": "totals", "seconds": time.perf_counter() - t_start,
          "sms": sms, "max_sm_clock_hz": clock_hz})
    emit({"kernels": kernels, "floor_ms": floor[FLOOR_REPS[-1]],
          "floor_ms_by_reps": {str(r): floor[r] for r in FLOOR_REPS}})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
