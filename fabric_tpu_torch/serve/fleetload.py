"""Fleet load generator: one "peer" process driving a sidecar or a fleet.

The port's counterpart of the JAX package's `serve/fleetload`: the peer
process of a multi-peer soak (N processes, not threads, multiplexing one
warm sidecar over real sockets). It signs a mixed valid/invalid lane set
once with the port's own `common/p256` (fixed keys, nonces drawn from the
seed), drives ``--requests`` batches through a `SidecarProvider` (or a
`SidecarRouter` when ``--endpoints`` lists a fleet) under one channel and
admission class, holds every mask to the ground truth by construction,
and prints ONE JSON summary line (requests, ok, mask_mismatches,
busy_rejects, degraded, p50/p99 ms, lanes/s)::

    python -m fabric_tpu_torch.serve.fleetload --address /path/s.sock \\
        --channel paychan --qos high --requests 16 --lanes 256 --seed 3

A batch the sidecar cannot serve is rescued in this process, which needs
the card (or raises, counted as a failed worker).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.serve import protocol as proto

LANE_KINDS = ("good", "bad_sig", "high_s", "garbage")


def build_lanes(
    n: int, seed: int
) -> Tuple[List, List[bytes], List[bytes], List[bool]]:
    """Mixed valid/invalid lanes with exact expected verdicts, seeded
    per peer: a good signature, a flipped byte, high-S, garbage DER."""
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey

    d_priv = 0xF1EE7 + seed * 7919
    pub = ECDSAPublicKey(*p256.base_mult(d_priv))
    keys, sigs, digests, expected = [], [], [], []
    for i in range(n):
        digest = hashlib.sha256(b"fleetload lane %d %d" % (seed, i)).digest()
        nonce = int.from_bytes(
            hashlib.sha256(b"fleetload nonce %d %d" % (seed, i)).digest(), "big"
        ) % (p256.N - 1) + 1
        r, s = p256.sign_digest(d_priv, digest, nonce)
        sig = der.marshal_signature(r, s)
        kind = LANE_KINDS[i % len(LANE_KINDS)]
        if kind == "bad_sig":
            bad = bytearray(sig)
            bad[-1] ^= 0x5A
            sig = bytes(bad)
        elif kind == "high_s":
            sig = der.marshal_signature(r, p256.N - s)
        elif kind == "garbage":
            sig = b"\x00\x01garbage"
        keys.append(pub)
        sigs.append(sig)
        digests.append(digest)
        expected.append(kind == "good")
    return keys, sigs, digests, expected


def _pct(sorted_s: Sequence[float], q: float) -> float:
    if not sorted_s:
        return 0.0
    i = min(len(sorted_s) - 1, max(0, int(round(q * (len(sorted_s) - 1)))))
    return sorted_s[i]


def run(
    address: Optional[str] = None,
    endpoints: Optional[Sequence[str]] = None,
    channel: str = "",
    qos: str = "normal",
    n_requests: int = 8,
    lanes: int = 256,
    seed: int = 0,
    fallback=None,
) -> dict:
    """Drive the load; returns the summary dict (also usable in-process;
    ``fallback`` is the rescue provider, the card's by default)."""
    qos_class = (
        proto.QOS_NAMES.index(qos) if qos in proto.QOS_NAMES
        else proto.DEFAULT_QOS
    )
    if endpoints:
        from fabric_tpu_torch.serve.router import SidecarRouter

        provider = SidecarRouter(endpoints=endpoints, qos_class=qos_class,
                                 channel=channel, fallback=fallback)
    else:
        from fabric_tpu_torch.serve.client import SidecarProvider

        provider = SidecarProvider(address=address, qos_class=qos_class,
                                   channel=channel, fallback=fallback)
    keys, sigs, digests, expected = build_lanes(lanes, seed)
    latencies: List[float] = []
    ok = mismatches = 0
    t_start = time.perf_counter()
    try:
        for _ in range(n_requests):
            t0 = time.perf_counter()
            mask = provider.batch_verify(keys, sigs, digests)
            latencies.append(time.perf_counter() - t0)
            if list(mask) == expected:
                ok += 1
            else:
                mismatches += 1
        wall_s = time.perf_counter() - t_start
        lat = sorted(latencies)
        summary = {
            "channel": channel,
            "cls": proto.qos_name(qos_class),
            "requests": n_requests,
            "lanes_per_request": lanes,
            "ok": ok,
            "mask_mismatches": mismatches,
            "busy_rejects": provider.busy_rejects,
            "degraded": provider.degraded,
            "deadline_expired": provider.deadline_expired,
            "hedges": getattr(provider, "hedges", 0),
            "hedge_wins": getattr(provider, "hedge_wins", 0),
            "slow_evictions": getattr(provider, "slow_evictions", 0),
            "p50_ms": round(_pct(lat, 0.50) * 1e3, 3),
            "p99_ms": round(_pct(lat, 0.99) * 1e3, 3),
            "wall_s": round(wall_s, 3),
            "lanes_per_s": round(n_requests * lanes / max(wall_s, 1e-9), 1),
        }
        if endpoints:
            summary["per_endpoint"] = [
                {k: ep[k] for k in ("address", "p99_ms", "ewma_ms", "healthy")}
                for ep in provider.describe()["endpoints"]
            ]
    finally:
        provider.stop()
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fabric_tpu_torch.serve.fleetload",
        description="one peer process of a multi-peer sidecar soak",
    )
    ap.add_argument("--address", default="")
    ap.add_argument(
        "--endpoints", default="",
        help="comma-separated fleet addresses (routes via SidecarRouter)",
    )
    ap.add_argument("--channel", default="")
    ap.add_argument("--qos", default="normal", choices=proto.QOS_NAMES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    endpoints = [a.strip() for a in args.endpoints.split(",") if a.strip()]
    if not endpoints and not args.address:
        ap.error("--address or --endpoints is required")
    summary = run(
        address=args.address or None,
        endpoints=endpoints or None,
        channel=args.channel,
        qos=args.qos,
        n_requests=args.requests,
        lanes=args.lanes,
        seed=args.seed,
    )
    print(json.dumps(summary, sort_keys=True), flush=True)
    # a peer that could not hold the mask contract is a failed worker
    return 0 if summary["mask_mismatches"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
