"""Batched Idemix signature verification (reference idemix/signature.go
Signature.Ver; BASELINE config #3).

The port's copy of the JAX package's `idemix/batch.py` device route. A
batch splits Signature.Ver into:

* host: the message parse, the Fiat-Shamir SHA-256 recompute and the
  challenge comparison;
* the card: the Ate2 pairing structure check of every lane (K4,
  `ops/pairing_kernel`), then the t1/t2/t3 commitments of the lanes that
  passed it as one G1 multi-scalar multiply (K3, `ops/bn256_kernel`),
  three MSM lanes a signature, padded to the largest job with identity
  bases and zero scalars.

Routes (`backend`): "device" (the default: K4 then K3), "hostbn" (the
numpy limb-matrix rung of `crypto/hostbn`, the whole batch's pairings and
MSMs as lanes, signature chunks sharded over a process pool past
`MIN_POOL_SIGS`) and "scheme" (the per-signature oracle loop of
`idemix/scheme.py`). `bccsp.idemix_backend_name()` names the host rung the
factory's BCCSP.SW.IdemixBackend pinned, for a caller that asks for the
host. The device route runs on the card unless the caller passes
`device="cpu"`, where the kernel wrappers run their plain versions;
without a card it raises. A lane that fails to parse or fails the pairing
is False, as in `verify_signature`; a device error is never turned into a
verdict. Every route counts its lanes in ``fabric_verify_lanes_total`` by
rung, and the ``idemix.verdict`` corrupt seam fires once a batch in the
coordinating process, never in a pool worker.

This module imports no torch at import time (the kernels' modules load
when the device route runs), so the hostbn pool's workers start light.

Departures from the JAX package: the default route is the device, not the
process-wide host ladder, and neither the `device_pairing` flag nor the
"msm" route (the host oracle's pairing, about a second a signature, with
K3) is ported: the device route always runs K4.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common import fp256bn as bn
from fabric_tpu_torch.common.faults import corrupt_verdicts, fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.retry import CooldownGate
from fabric_tpu_torch.crypto import hostec
from fabric_tpu_torch.idemix.scheme import (
    ALG_NO_REVOCATION,
    IdemixError,
    _hidden_indices,
    _second_challenge,
    _signature_challenge,
    ecp2_from_proto,
    ecp_from_proto,
    verify_signature,
)

logger = must_get_logger("idemix.batch")

BACKENDS = ("device", "hostbn", "scheme")

class _Parsed:
    """Host-parsed signature with its three MSM jobs."""

    def __init__(self, sig: dict, disclosure, ipk: dict, attribute_values, rh_index):
        hidden = _hidden_indices(disclosure)
        self.sig = sig
        self.disclosure = disclosure
        self.a_prime = ecp_from_proto(sig.get("a_prime"))
        self.a_bar = ecp_from_proto(sig.get("a_bar"))
        self.b_prime = ecp_from_proto(sig.get("b_prime"))
        self.nym = ecp_from_proto(sig.get("nym"))
        if self.a_prime is None:
            raise IdemixError("signature invalid: APrime = 1")
        if len(sig.get("proof_s_attrs", [])) != len(hidden):
            raise IdemixError("incorrect amount of s-values")
        alg = (sig.get("non_revocation_proof") or {}).get("revocation_alg", 0)
        if alg != ALG_NO_REVOCATION:
            raise IdemixError("unknown revocation algorithm")

        def big(name):
            return bn.big_from_bytes(sig.get(name, b""))

        c = big("proof_c")
        s_sk, s_e, s_r2, s_r3 = big("proof_s_sk"), big("proof_s_e"), big("proof_s_r2"), big("proof_s_r3")
        s_s_prime, s_r_nym = big("proof_s_s_prime"), big("proof_s_r_nym")
        s_attrs = [bn.big_from_bytes(v) for v in sig.get("proof_s_attrs", [])]
        self.proof_c = c
        self.nonce = big("nonce")

        h_rand = ecp_from_proto(ipk.get("h_rand"))
        h_sk = ecp_from_proto(ipk.get("h_sk"))
        neg_c = (-c) % bn.R

        # t1 = s_e·A' + s_r2·HRand − c·(ABar − B')
        self.t1_job = (
            [self.a_prime, h_rand, bn.g1_add(self.a_bar, bn.g1_neg(self.b_prime))],
            [s_e, s_r2, neg_c],
        )
        # t2 = s_s'·HRand + s_r3·B' + s_sk·HSk + Σ_hidden s_i·HAttr_i
        #      + c·(G1 + Σ_disclosed a_i·HAttr_i)
        bases = [h_rand, self.b_prime, h_sk]
        scalars = [s_s_prime, s_r3, s_sk]
        for j, idx in enumerate(hidden):
            bases.append(ecp_from_proto(ipk["h_attrs"][idx]))
            scalars.append(s_attrs[j])
        bases.append(bn.G1_GEN)
        scalars.append(c)
        for idx, disclose in enumerate(disclosure):
            if disclose != 0:
                bases.append(ecp_from_proto(ipk["h_attrs"][idx]))
                scalars.append((c * attribute_values[idx]) % bn.R)
        self.t2_job = (bases, scalars)
        # t3 = s_sk·HSk + s_r_nym·HRand − c·Nym
        self.t3_job = ([h_sk, h_rand, self.nym], [s_sk, s_r_nym, neg_c])


def _parse_lanes(signatures, disclosures, ipk, attribute_values_list, rh_index):
    parsed: List[Optional[_Parsed]] = []
    names = ipk.get("attribute_names", [])
    for sig, disclosure, values in zip(signatures, disclosures, attribute_values_list):
        try:
            if rh_index < 0 or rh_index >= len(names) or len(disclosure) != len(names):
                raise IdemixError("invalid input")
            parsed.append(_Parsed(sig, disclosure, ipk, values, rh_index))
        except Exception:  # any parse failure makes the lane False, as in the JAX package
            parsed.append(None)
    return parsed


def _challenge_results(parsed, ipk, msgs, t_points) -> List[bool]:
    """Fiat-Shamir recompute over the batch's t1/t2/t3 points; `t_points`
    maps a lane index to its (t1, t2, t3)."""
    results = [False] * len(parsed)
    for i, (t1, t2, t3) in t_points.items():
        p = parsed[i]
        c = _signature_challenge(t1, t2, t3, p.a_prime, p.a_bar, p.b_prime, p.nym, b"",
                                 ipk.get("hash", b""), p.disclosure, msgs[i])
        results[i] = p.proof_c == _second_challenge(c, p.nonce)
    return results


def verify_signatures_batch(
    signatures: Sequence[dict],
    disclosures: Sequence[Sequence[int]],
    ipk: dict,
    msgs: Sequence[bytes],
    attribute_values_list: Sequence[Sequence[Optional[int]]],
    rh_index: int,
    backend: Optional[str] = None,
    device=None,
    split_ms: Optional[Dict[str, float]] = None,
    _pool_ok: bool = True,
) -> List[bool]:
    """Batch Signature.Ver: the per-signature validity mask, equal to
    `verify_signature`'s verdicts lane by lane on every route.

    `backend` is "device" (the default), "hostbn" or "scheme"; `device` is
    where the device route runs (the card unless "cpu"). The device route
    fills `split_ms`, when given, with its host-clock milliseconds: parse,
    pairing (K4 launch and wait), msm (the K3 step) and challenge, and the
    K3 step's msm_pack, msm_kernel and msm_unpack (`msm_host_batch`)."""
    backend = backend or "device"
    if backend not in BACKENDS:
        raise ValueError(f"unknown idemix batch backend {backend!r}")
    if backend == "device":
        from fabric_tpu_torch.ops import cudalib

        dev = cudalib.resolve_device(device, "Idemix")
    if not signatures:
        return []
    t0 = time.perf_counter()
    if backend == "hostbn":
        out = _verify_hostbn(signatures, disclosures, ipk, msgs, attribute_values_list,
                             rh_index, pool_ok=_pool_ok)
    elif backend == "scheme":
        out = _verify_scheme(signatures, disclosures, ipk, msgs, attribute_values_list, rh_index)
    else:
        out = _verify_device(signatures, disclosures, ipk, msgs, attribute_values_list, rh_index,
                             device=dev, split_ms={} if split_ms is None else split_ms)
    if not _pool_ok:
        # a pool worker's chunk: the coordinating process counts and
        # corrupts the whole batch once (two flips would cancel)
        return out
    fabobs.obs_count("fabric_verify_lanes_total", len(signatures), rung=backend)
    fabobs.obs_observe("fabric_verify_seconds", time.perf_counter() - t0, rung=backend)
    return _chaos_verdicts(out)


def _chaos_verdicts(out: List[bool]) -> List[bool]:
    """``idemix.verdict`` corrupt seam (the batch analog of
    ``bccsp.verdict``): only an installed fault plan reaches the flip — it
    exists so a bit-exact mask assertion can be shown to CATCH a
    corrupted verdict."""
    spec = fault_point("idemix.verdict", interprets=("corrupt",))
    if spec is not None and spec.action == "corrupt":
        return corrupt_verdicts(out, spec)
    return out


def _verify_scheme(signatures, disclosures, ipk, msgs, attribute_values_list,
                   rh_index) -> List[bool]:
    out = []
    for sig, disclosure, msg, values in zip(signatures, disclosures, msgs,
                                            attribute_values_list):
        try:
            verify_signature(sig, disclosure, ipk, msg, values, rh_index, None, 0)
            out.append(True)
        except Exception:  # any oracle rejection is a False lane, never a batch error
            out.append(False)
    return out


# ---------------------------------------------------------------------------
# hostbn rung: numpy limb-matrix lanes (+ process-pool sharding)
# ---------------------------------------------------------------------------

MIN_POOL_SIGS = 64  # below this a pool round-trip costs more than it buys
MIN_SHARD_SIGS = 16  # never split shards smaller than this


def _lane_jobs(parsed, pairing_ok):
    """The t1/t2/t3 MSM jobs of every lane that parsed and passed the
    pairing, and each job's lane."""
    jobs: List[Tuple[list, list]] = []
    owners: List[int] = []
    for i, p in enumerate(parsed):
        if p is None or not pairing_ok[i]:
            continue
        for job in (p.t1_job, p.t2_job, p.t3_job):
            jobs.append(job)
            owners.append(i)
    return jobs, owners


def _verify_hostbn(signatures, disclosures, ipk, msgs, attribute_values_list, rh_index,
                   pool_ok: bool = True) -> List[bool]:
    from fabric_tpu_torch.crypto import hostbn

    n = len(signatures)
    if pool_ok and n >= MIN_POOL_SIGS:
        out = _verify_hostbn_pooled(signatures, disclosures, ipk, msgs,
                                    attribute_values_list, rh_index)
        if out is not None:
            return out
    parsed = _parse_lanes(signatures, disclosures, ipk, attribute_values_list, rh_index)
    w = ecp2_from_proto(ipk.get("w"))
    pairing_ok = hostbn.pairing_check_batch(
        w, [(p.a_prime, p.a_bar) if p is not None else None for p in parsed])
    jobs, owners = _lane_jobs(parsed, pairing_ok)
    t_points: Dict[int, list] = {}
    if jobs:
        for owner, pt in zip(owners, hostbn.msm_batch(jobs)):
            t_points.setdefault(owner, []).append(pt)
    return _challenge_results(parsed, ipk, msgs, t_points)


# shared-nothing pool: shards are chunks of SIGNATURES (the decoded
# message dicts pickle as they are), workers run the inline hostbn path
# and the parent concatenates in order
_POOL = None
_POOL_PROCS = 1
_POOL_LOCK = threading.Lock()
_POOL_GATE = CooldownGate()


def pool_procs() -> int:
    """Worker count (1 = pool disabled); FABRIC_TPU_HOSTBN_PROCS
    overrides, falling back to hostec's discipline (malformed values
    degrade to the default, never raise)."""
    procs = os.environ.get("FABRIC_TPU_HOSTBN_PROCS", "")
    if procs:
        try:
            return max(int(procs), 1)
        except ValueError:
            pass
    return hostec.pool_procs()


def _pool():
    """Lazy shared ProcessPoolExecutor, started by `hostec.start_method()`
    (never a fork).  Broken or
    unavailable pools degrade to inline compute, never die."""
    global _POOL, _POOL_PROCS
    with _POOL_LOCK:
        if _POOL is None:
            if not _POOL_GATE.ready():
                return None
            procs = pool_procs()
            _POOL_PROCS = procs
            if procs <= 1:
                _POOL = False
                return None
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            try:
                _POOL = ProcessPoolExecutor(
                    max_workers=procs,
                    mp_context=multiprocessing.get_context(hostec.start_method()),
                )
                fabobs.obs_count("fabric_pool_rebuilds_total", pool="hostbn")
            except Exception as exc:  # pragma: no cover - restricted environments
                logger.warning("idemix pool unavailable (%s); verifying inline", exc)
                _POOL = False
    return _POOL or None


def reset_pool_cooldown() -> None:
    """Close the rebuild cooldown and reset its ramp (a test exercises
    the ``hostbn.pool.submit`` and ``hostbn.pool.resolve`` faults
    back-to-back without waiting out the cooldown a broken-pool teardown
    arms)."""
    _POOL_GATE.record_success()


def shutdown_pool(broken: bool = False) -> None:
    """Tear the pool down; ``broken=True`` arms the rebuild cooldown
    (degrade paths only — clean teardowns leave the gate closed)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL:
            _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None
        if broken:
            _POOL_GATE.record_failure()
    if broken:
        fabobs.obs_count("fabric_pool_cooldowns_total", pool="hostbn")
        fabobs.obs_count("fabric_degrade_total", seam="hostbn.pool")
        fabobs.obs_trigger("hostbn.pool_broken")


def _pool_worker(ipk, signatures, disclosures, msgs, values, rh_index) -> List[bool]:
    """Runs in a pool worker: verify the chunk inline on the hostbn rung
    (per-worker issuer schedules are cached across batches by
    crypto/hostbn)."""
    return verify_signatures_batch(signatures, disclosures, ipk, msgs, values, rh_index,
                                   backend="hostbn", _pool_ok=False)


def _verify_hostbn_pooled(signatures, disclosures, ipk, msgs, attribute_values_list,
                          rh_index) -> Optional[List[bool]]:
    """Shard the batch across the process pool; None = caller verifies
    inline (no pool, submit failure, worker death — degrade, never
    die)."""
    pool = _pool()
    if pool is None:
        return None
    n = len(signatures)
    nshards = min(_POOL_PROCS,
                  max(n // MIN_SHARD_SIGS, 1))
    if nshards <= 1:
        return None
    step = (n + nshards - 1) // nshards
    try:
        fault_point("hostbn.pool.submit")
        futures = [
            pool.submit(_pool_worker, ipk, list(signatures[lo: lo + step]),
                        list(disclosures[lo: lo + step]), list(msgs[lo: lo + step]),
                        list(attribute_values_list[lo: lo + step]), rh_index)
            for lo in range(0, n, step)
        ]
    except Exception as exc:  # BrokenProcessPool / shutdown race
        logger.warning("idemix pool submit failed (%s); verifying inline", exc)
        shutdown_pool(broken=True)
        return None
    try:
        fault_point("hostbn.pool.resolve")
        out: List[bool] = []
        for f in futures:
            out.extend(f.result())
        with _POOL_LOCK:
            # a batch that made it THROUGH the pool resets the rebuild
            # cooldown ramp (construction alone proves nothing)
            _POOL_GATE.record_success()
        return out
    except Exception as exc:  # worker died mid-run: inline fallback
        logger.warning("idemix pool worker died mid-batch (%s); verifying inline", exc)
        shutdown_pool(broken=True)
        return None


# ---------------------------------------------------------------------------
# device route: K4, then K3
# ---------------------------------------------------------------------------


def _verify_device(signatures, disclosures, ipk, msgs, attribute_values_list, rh_index,
                   device, split_ms: Dict[str, float]) -> List[bool]:
    """K4 over every lane, then one K3 batch of three MSM lanes for each
    signature that passed it."""
    from fabric_tpu_torch.ops import bn256_kernel, pairing_kernel

    t0 = time.perf_counter()
    parsed = _parse_lanes(signatures, disclosures, ipk, attribute_values_list, rh_index)
    w = ecp2_from_proto(ipk.get("w"))
    t1 = time.perf_counter()
    # pairing structure check: e(W, A') * e(g2, ABar)^-1 == 1
    kernel = pairing_kernel.kernel_for_issuer(bn.g2_to_bytes(w), device)
    pairing_ok = kernel.check([(p.a_prime, p.a_bar) if p is not None else None for p in parsed])
    t2 = time.perf_counter()

    jobs, owners = _lane_jobs(parsed, pairing_ok)
    t_points: Dict[int, list] = {}
    if jobs:
        k_max = max(len(b) for b, _ in jobs)
        bases = [list(b) + [None] * (k_max - len(b)) for b, _ in jobs]
        scalars = [list(s) + [0] * (k_max - len(s)) for _, s in jobs]
        points = bn256_kernel.msm_host_batch(bases, scalars, device, split_ms)
        for owner, pt in zip(owners, points):
            t_points.setdefault(owner, []).append(pt)
    t3 = time.perf_counter()
    out = _challenge_results(parsed, ipk, msgs, t_points)
    t4 = time.perf_counter()
    split_ms.update(parse=(t1 - t0) * 1e3, pairing=(t2 - t1) * 1e3, msm=(t3 - t2) * 1e3,
                   challenge=(t4 - t3) * 1e3)
    return out
