"""The lane-bucket ladder and the warm-once program registry.

The port's counterpart of the JAX package's `serve/registry`. A resident
sidecar owns one registry, warms every bucket of the fixed ladder before
it takes traffic, and serves from the warm table: an unwarmed bucket is
an error (`program_for` raises KeyError), never a build on the hot path.

What a "program" is here. The JAX registry warms an AOT-compiled XLA
executable a bucket, from one of three rungs: the serialized artifact,
the persistent compile cache, or a cold compile. The port has no JIT;
its counterparts are

1. the build cache of `ops/cudalib` (`build/torch_kernels/<name>-<sha256
   of the source>.so`): a warm start loads the library a previous process
   built; a cold one runs `nvcc` once;
2. one timed launch of the kernel at the bucket's shape, checked against
   its expected verdicts, so the module load and the first launch's cost
   are paid before the first request.

No CUDA Graph is captured: the sidecar uses the registry for `bucket_for`
and the warm accounting only, and dispatches through the batcher to its
provider, so a graph would have nothing to replay it.

`stats()` keeps the JAX keys. Fields with no counterpart are renamed:
per bucket, ``xla_compiles`` becomes ``builds`` (the `nvcc` runs the
bucket's warm paid) and ``cache_hits`` counts libraries found in the build
cache, with ``launch_ms`` beside them; ``aot_hit`` and the trace counter
have no counterpart and are gone; ``process_xla_compiles`` becomes
``process_builds``.

Ladders: ``verify`` launches K1 (`ops/p256_kernel.verify_batch`, the
limb route) at each bucket, as the JAX ladder warms its limb program;
``demo`` runs the port's `ops/bignum` Montgomery exponentiation
(x^65537 mod P-256's p) at each bucket, small enough for the CPU tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Sequence, Tuple

from fabric_tpu_torch.common.flogging import must_get_logger

logger = must_get_logger("serve.registry")

#: The default lane-bucket ladder (the provider's `_BUCKETS`: a request
#: is padded up to the smallest bucket that fits).
DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest ladder bucket >= n; oversize rounds up to a multiple of
    the top bucket."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def _load_events() -> Tuple[int, int]:
    from fabric_tpu_torch.ops import cudalib

    return cudalib.LOAD_EVENTS["builds"], cudalib.LOAD_EVENTS["cache_hits"]


class BucketProgramRegistry:
    """Warm table keyed by lane bucket.

    ``builder(bucket)`` returns ``(callable, meta)``: the bucket's warm
    program and its accounting (``launch_ms`` for the kernel ladders).
    """

    def __init__(
        self,
        buckets: Sequence[int],
        builder: Callable[[int], Tuple[Callable, Dict]],
        label: str = "program",
    ):
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"bucket ladder must be sorted unique: {buckets!r}")
        self.buckets = tuple(int(b) for b in buckets)
        self.builder = builder
        self.label = label
        self._programs: Dict[int, Callable] = {}
        self._lock = threading.Lock()
        self.warm_report: Dict[int, Dict] = {}
        self.warmed = False

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    def warm(self) -> Dict[int, Dict]:
        """Build or load every bucket's program and launch it once,
        recording per-bucket wall ms and the build-cache events the warm
        moved.  Idempotent."""
        with self._lock:
            if self.warmed:
                return self.warm_report
            for b in self.buckets:
                b0, h0 = _load_events()
                t0 = time.perf_counter()
                program, meta = self.builder(b)
                wall_ms = (time.perf_counter() - t0) * 1000.0
                b1, h1 = _load_events()
                self._programs[b] = program
                report = {
                    "warm_ms": round(wall_ms, 3),
                    "builds": b1 - b0,
                    "cache_hits": h1 - h0,
                }
                report.update(meta)
                self.warm_report[b] = report
                logger.info(
                    "%s bucket %d warm in %.1fms (%s)", self.label, b, wall_ms,
                    "built" if b1 > b0 else ("cache" if h1 > h0 else "loaded"),
                )
            self.warmed = True
            return self.warm_report

    def program_for(self, n: int) -> Tuple[int, Callable]:
        """(bucket, warm program) for an n-lane request.  Raises KeyError
        when the bucket was never warmed — steady state must not build,
        so a missing bucket is a caller bug, not a trigger for one."""
        b = self.bucket_for(n)
        with self._lock:
            program = self._programs.get(b)
        if program is None:
            raise KeyError(
                f"bucket {b} not warmed for {self.label} "
                f"(ladder {self.buckets})"
            )
        return b, program

    def stats(self) -> Dict:
        with self._lock:
            report = {str(k): dict(v) for k, v in self.warm_report.items()}
        builds, hits = _load_events()
        return {
            "label": self.label,
            "buckets": list(self.buckets),
            "warmed": self.warmed,
            "per_bucket": report,
            "process_builds": builds,
            "process_cache_hits": hits,
        }

    @classmethod
    def for_program(
        cls,
        fn: Callable,
        inputs_for: Callable[[int], Tuple],
        check: Callable[[object, int], None],
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        label: str = "program",
    ) -> "BucketProgramRegistry":
        """Registry whose bucket b is ``fn`` launched once on
        ``inputs_for(b)`` (timed with a synchronize on the card) and its
        output held by ``check(out, b)``, which raises on a wrong one."""
        import torch

        def builder(bucket: int) -> Tuple[Callable, Dict]:
            args = inputs_for(bucket)
            device = args[0].device
            t0 = time.perf_counter()
            out = fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            launch_ms = (time.perf_counter() - t0) * 1000.0
            check(out, bucket)
            return fn, {"launch_ms": round(launch_ms, 3)}

        return cls(buckets, builder, label=label)


# ---------------------------------------------------------------------------
# The ladders
# ---------------------------------------------------------------------------


def demo_limb_program(device):
    """(fn, inputs_for, check) of a small-but-real limb program: Montgomery
    exponentiation x^65537 mod P-256's p over a (20, bucket) lane batch,
    the port's `ops/bignum`, checked lane by lane against Python's pow."""
    import torch

    from fabric_tpu_torch.common import p256
    from fabric_tpu_torch.ops import bignum as bn

    ctx = bn.MontCtx(p256.P)
    base = [(i * 0x9E3779B97F4A7C15 + 7) % p256.P for i in range(8)]

    def fn(x):
        xm = bn.to_mont(ctx, x)
        return bn.from_mont(ctx, bn.mont_pow(ctx, xm, 65537))

    def inputs_for(bucket: int):
        xs = [base[i % len(base)] for i in range(bucket)]
        return (bn.ints_to_limbs(xs).to(torch.device(device)),)

    def check(out, bucket: int) -> None:
        want = [pow(base[i % len(base)], 65537, p256.P) for i in range(len(base))]
        got = bn.limbs_to_ints(out[:, : len(base)].cpu())
        if got != want[: min(len(base), bucket)]:
            raise RuntimeError(f"demo program wrong at bucket {bucket}")

    return fn, inputs_for, check


def verify_limb_program(device):
    """(fn, inputs_for, check) of K1 (`p256_kernel.verify_batch`) at each
    bucket: one valid lane (a fixed key, digest and nonce signed by the
    oracle) tiled to the bucket, every verdict required True."""
    import hashlib

    import numpy as np
    import torch

    from fabric_tpu_torch.common import p256
    from fabric_tpu_torch.crypto.cuda_provider import be_bytes_to_limbs
    from fabric_tpu_torch.ops import p256_kernel as pk

    priv = 0x5EED5EED
    qx, qy = p256.base_mult(priv)
    digest = hashlib.sha256(b"serve registry warm lane").digest()
    r, s = p256.sign_digest(priv, digest, 0xC0FFEE)
    # (20, 5) limb columns of e, r, s, qx, qy, as CUDAProvider prepares them
    column = be_bytes_to_limbs(np.frombuffer(
        digest + b"".join(v.to_bytes(32, "big") for v in (r, s, qx, qy)),
        dtype=np.uint8).reshape(5, 32))
    dev = torch.device(device)

    def inputs_for(bucket: int):
        cols = [torch.from_numpy(np.repeat(column[:, i:i + 1], bucket, axis=1)).to(dev)
                for i in range(5)]
        return (*cols, torch.ones(bucket, dtype=torch.bool, device=dev))

    def check(out, bucket: int) -> None:
        if not bool(out.all()):
            raise RuntimeError(f"K1 refused the warm lane at bucket {bucket}")

    return pk.verify_batch, inputs_for, check
