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

Routes (`backend`): "device" (the default: K4 then K3) and "scheme" (the
per-signature oracle loop of `idemix/scheme.py`). The device route runs on
the card unless the caller passes `device="cpu"`, where the kernel wrappers
run their plain versions; without a card it raises. A lane that fails to
parse or fails the pairing is False, as in `verify_signature`; a device
error is never turned into a verdict.

Departures from the JAX package: no hostbn rung and no process pool, no
`idemix.verdict` fault seam and no fabobs counters, and neither the
`device_pairing` flag nor the "msm" route (the host oracle's pairing, about
a second a signature, with K3): the device route always runs K4.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fp256bn as bn
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
from fabric_tpu_torch.ops import bn256_kernel, cudalib, pairing_kernel

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
) -> List[bool]:
    """Batch Signature.Ver: the per-signature validity mask, equal to
    `verify_signature`'s verdicts lane by lane on every route.

    `backend` is "device" (the default) or "scheme"; `device` is where the
    device route runs (the card unless "cpu"). The device route fills
    `split_ms`, when given, with its host-clock milliseconds: parse,
    pairing (K4 launch and wait), msm (the K3 step) and challenge, and the
    K3 step's msm_pack, msm_kernel and msm_unpack (`msm_host_batch`)."""
    backend = backend or "device"
    if backend == "scheme":
        return _verify_scheme(signatures, disclosures, ipk, msgs, attribute_values_list, rh_index)
    if backend != "device":
        raise ValueError(f"unknown idemix batch backend {backend!r}")
    dev = cudalib.resolve_device(device, "Idemix")
    if not signatures:
        return []
    return _verify_device(signatures, disclosures, ipk, msgs, attribute_values_list, rh_index,
                          device=dev, split_ms={} if split_ms is None else split_ms)


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


def _verify_device(signatures, disclosures, ipk, msgs, attribute_values_list, rh_index,
                   device, split_ms: Dict[str, float]) -> List[bool]:
    """K4 over every lane, then one K3 batch of three MSM lanes for each
    signature that passed it."""
    t0 = time.perf_counter()
    parsed = _parse_lanes(signatures, disclosures, ipk, attribute_values_list, rh_index)
    w = ecp2_from_proto(ipk.get("w"))
    t1 = time.perf_counter()
    # pairing structure check: e(W, A') * e(g2, ABar)^-1 == 1
    kernel = pairing_kernel.kernel_for_issuer(bn.g2_to_bytes(w), device)
    pairing_ok = kernel.check([(p.a_prime, p.a_bar) if p is not None else None for p in parsed])
    t2 = time.perf_counter()

    jobs: List[Tuple[list, list]] = []
    owners: List[int] = []
    for i, p in enumerate(parsed):
        if p is None or not pairing_ok[i]:
            continue
        for job in (p.t1_job, p.t2_job, p.t3_job):
            jobs.append(job)
            owners.append(i)
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
