"""The resident validation sidecar: the BCCSP as a long-lived process
that owns the card, serving batch verification to peers over a local
socket.

The port's counterpart of the JAX package's `serve/`:

- `serve.protocol` — length-prefixed local socket framing
  (VERIFY/PING/STATS/SHUTDOWN/DRAIN/CANCEL) with explicit admission-control
  statuses (ST_BUSY + retry_after_ms), revisions 1-3, byte for byte the
  JAX package's wire contract.
- `serve.registry` — the lane-bucket ladder and the warm-once registry
  (a bucket's kernel built or loaded from the build cache, and launched
  once, before traffic).
- `serve.server` — the sidecar: owns a `CUDAProvider` for its lifetime,
  fronts it with the VerifyBatcher's bounded-lane admission and the
  per-class QoS ledger, serves batches over the socket.
- `serve.client` — the BCCSP rung: `SidecarProvider` routes batch
  verification through the sidecar and rescues a batch the sidecar cannot
  serve on an in-process provider (the card's, or the caller's).
- `serve.qos` — per-class admission budgets with work-conserving
  borrowing.
- `serve.router` — the fleet rung: bucket-aware placement across N
  sidecar endpoints, health-probe eviction, hedging, re-verify on kill.
- `serve.fleetload` — one peer process driving a sidecar or a fleet.

Import the submodules directly; this package namespace stays empty.
"""
