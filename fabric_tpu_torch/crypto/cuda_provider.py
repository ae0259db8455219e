"""The CUDA-backed BCCSP provider.

The port's counterpart of the JAX package's `crypto/tpu_provider.TPUProvider`:
the same single-verify and batch API and the same decisions on the host
(DER parse, the low-S rule, the 1 <= r, s < n checks, distinct-key columns
cached by SKI with an on-curve gate, the lane buckets, the 32-column key
bucket with the limb route past it). The curve math runs in the
hand-written kernels of `ops/p256_kernel`; on the card the provider also
keeps each key's comb (the fixed-base table K2 reads, built by
`p256_key_tables`) by SKI, so a key's table is built once.

Each provider counts the kernels it launches on the card (`launches`,
beside the process-wide `p256_kernel.LAUNCHES`), so with two providers in
one process (two sidecars, or a sidecar and a client's rescue) each one's
launches are told apart. Its caches and counts take a lock: a sidecar's
dispatcher thread and a rescue may use one provider at once.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from fabric_tpu_torch.common import p256
from fabric_tpu_torch.common.limbparams import LIMB_BITS, NLIMBS
from fabric_tpu_torch.crypto.bccsp import (
    ECDSAPublicKey,
    Provider,
    VerifyError,
    parse_and_precheck,
)
from fabric_tpu_torch.crypto.sigparse import batch_der_parse
from fabric_tpu_torch.ops import p256_kernel as pk

_BUCKETS = [128, 256, 512, 1024, 2048, 4096, 8192, 16384]


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + _BUCKETS[-1] - 1) // _BUCKETS[-1]) * _BUCKETS[-1]


def be_bytes_to_limbs(rows: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 big-endian byte rows -> (20, B) int64 13-bit limbs.

    Vectorized: unpack to bits, regroup in 13-bit windows.
    """
    b = rows.shape[0]
    bits = np.unpackbits(rows[:, ::-1], axis=1, bitorder="little")  # (B, 256)
    pad = np.zeros((b, NLIMBS * LIMB_BITS - 256), dtype=bits.dtype)
    bits = np.concatenate([bits, pad], axis=1).reshape(b, NLIMBS, LIMB_BITS)
    weights = 1 << np.arange(LIMB_BITS, dtype=np.int64)
    limbs = (bits.astype(np.int64) * weights).sum(axis=2)
    return np.ascontiguousarray(limbs.T)


def _pad(a: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    pad = size - a.shape[axis]
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


class CUDAProvider(Provider):
    """Batched device verification with Fabric's decision semantics.

    It departs from `TPUProvider` in three deliberate ways:

    1. No retries, no software fallback and no `degraded` flag: a failed
       build, launch or copy raises.
    2. No host route for small batches (`MIN_DEVICE_BATCH`): every batch
       goes to the device. On an H100 a K2 round trip beat
       `SoftwareProvider.batch_verify` at 2 and at 31 lanes
       (`chip_smoke.py`, factory_config2's `direct_batch`), so there is
       no measured size below which the host wins. Single `verify()` runs
       `parse_and_precheck` (keeping the VerifyError semantics) and then
       a one-lane launch.
    3. `describe_backend()` is "cuda", or "cpu-reference" when the provider
       was made with `device="cpu"` and runs the kernels' plain versions.
    """

    # distinct keys are padded to a fixed column bucket; past it the lanes
    # carry full limb columns (the limb route)
    KEY_BUCKET = 32
    # keys whose combs (98,304 bytes each) stay on the card
    KEY_TABLE_CACHE = 1024

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDAProvider: no CUDA device is present")
        elif self.device.type != "cpu":
            raise ValueError(f"CUDAProvider: unsupported device {self.device}")
        self._key_limb_cache: Dict[bytes, Tuple[np.ndarray, np.ndarray, bool]] = {}
        self._key_table_cache: Dict[bytes, torch.Tensor] = {}
        self._lock = threading.Lock()
        # the kernels this provider launched on the card, by wrapper name
        self.launches: Dict[str, int] = dict.fromkeys(pk.LAUNCHES, 0)

    def _count(self, name: str) -> None:
        if self.device.type == "cuda":
            with self._lock:
                self.launches[name] += 1

    def describe_backend(self) -> str:
        return "cuda" if self.device.type == "cuda" else "cpu-reference"

    # -- host prep ---------------------------------------------------------

    def _key_columns(self, distinct: Sequence[ECDSAPublicKey]):
        """(x limbs, y limbs, on_curve) per DISTINCT key, cached by SKI.
        The on-curve gate matters: the complete formulas are only defined
        for curve points, so off-curve keys fail in the host mask."""
        skis = [key.ski() for key in distinct]
        with self._lock:
            missing = [i for i, ski in enumerate(skis) if ski not in self._key_limb_cache]
            if missing:
                xb = np.frombuffer(
                    b"".join(distinct[i].x.to_bytes(32, "big") for i in missing),
                    dtype=np.uint8,
                ).reshape(len(missing), 32)
                yb = np.frombuffer(
                    b"".join(distinct[i].y.to_bytes(32, "big") for i in missing),
                    dtype=np.uint8,
                ).reshape(len(missing), 32)
                xl = be_bytes_to_limbs(xb)
                yl = be_bytes_to_limbs(yb)
                if len(self._key_limb_cache) > 65536:
                    self._key_limb_cache.clear()
                for j, i in enumerate(missing):
                    key = distinct[i]
                    self._key_limb_cache[skis[i]] = (
                        np.ascontiguousarray(xl[:, j]),
                        np.ascontiguousarray(yl[:, j]),
                        p256.is_on_curve((key.x, key.y)),
                    )
            return [self._key_limb_cache[ski] for ski in skis]

    def _dedup_key_columns(self, keys: Sequence[ECDSAPublicKey]):
        """One limb conversion and curve check per distinct key object,
        plus the per-lane column index."""
        columns: Dict[int, int] = {}
        distinct: List[ECDSAPublicKey] = []
        idx = np.zeros(len(keys), dtype=np.int32)
        for i, key in enumerate(keys):
            col = columns.get(id(key))
            if col is None:
                col = len(distinct)
                columns[id(key)] = col
                distinct.append(key)
            idx[i] = col
        cols = self._key_columns(distinct)
        kx_cols = [c[0] for c in cols]
        ky_cols = [c[1] for c in cols]
        on_curve = np.asarray([c[2] for c in cols], dtype=bool)
        return kx_cols, ky_cols, on_curve, idx, [key.ski() for key in distinct]

    def _parse(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ):
        """The host prep both routes share: the native DER parse (high-S
        and malformed lanes dead), the digests as rows, the distinct-key
        columns (off-curve keys' lanes dead)."""
        n = len(signatures)
        if not (len(keys) == n == len(digests)):
            raise ValueError("keys, signatures and digests differ in length")
        r_bytes, s_bytes, ok_u8, low_s = batch_der_parse(signatures)
        ok = (ok_u8 & low_s).astype(bool)
        if any(len(d) != 32 for d in digests):
            raise VerifyError("digests must be 32-byte SHA-256 outputs")
        e_bytes = np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(n, 32).copy()
        kx_cols, ky_cols, on_curve, idx, skis = self._dedup_key_columns(keys)
        if kx_cols:
            ok &= on_curve[idx]
        return e_bytes, r_bytes, s_bytes, kx_cols, ky_cols, idx, skis, ok

    @staticmethod
    def _limbs(e_bytes, r_bytes, s_bytes, kx_cols, ky_cols, idx, ok):
        """K1's inputs: (e, r, s, qx, qy) (20, n) int64 limbs, each lane
        with its key's columns, and the (n,) mask."""
        if kx_cols:
            qx = np.stack(kx_cols, axis=1)[:, idx]
            qy = np.stack(ky_cols, axis=1)[:, idx]
        else:
            qx = qy = np.zeros((NLIMBS, len(ok)), dtype=np.int64)
        return (be_bytes_to_limbs(e_bytes), be_bytes_to_limbs(r_bytes),
                be_bytes_to_limbs(s_bytes), qx, qy, ok)

    def prep_bytes(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ):
        """DER parse and key-column dedup. Returns (prep, None) for the bytes
        route, or (None, limbs) when the distinct keys exceed KEY_BUCKET.
        prep is (e, r, s, kx, ky, key index, the key columns' SKIs, ok)."""
        e_bytes, r_bytes, s_bytes, kx_cols, ky_cols, idx, skis, ok = self._parse(
            keys, signatures, digests)
        if len(kx_cols) > self.KEY_BUCKET:
            return None, self._limbs(e_bytes, r_bytes, s_bytes, kx_cols, ky_cols, idx, ok)
        kx_mat = np.zeros((NLIMBS, self.KEY_BUCKET), dtype=np.int64)
        ky_mat = np.zeros((NLIMBS, self.KEY_BUCKET), dtype=np.int64)
        if kx_cols:
            kx_mat[:, : len(kx_cols)] = np.stack(kx_cols, axis=1)
            ky_mat[:, : len(ky_cols)] = np.stack(ky_cols, axis=1)
        return (e_bytes, r_bytes, s_bytes, kx_mat, ky_mat, idx, skis, ok), None

    def prep_limbs(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ):
        """The limb route's host prep whatever the number of keys (the
        multi-channel path, `parallel/multichannel.py`; the counterpart of
        `TPUProvider.prep_limbs`): (e, r, s, qx, qy) (20, n) int64 limbs and
        the (n,) bool mask, ready for K1 (`p256_kernel.verify_batch`)."""
        e_bytes, r_bytes, s_bytes, kx_cols, ky_cols, idx, _skis, ok = self._parse(
            keys, signatures, digests)
        return self._limbs(e_bytes, r_bytes, s_bytes, kx_cols, ky_cols, idx, ok)

    # -- device dispatch ---------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def key_tables(self, skis: Sequence[bytes], kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
        """The combs of a bytes-route batch's key columns, (KEY_BUCKET, 64,
        16, 3, 8) on the card: the keys not yet cached are built by one
        `p256_key_tables` launch and kept by SKI; the padding columns repeat
        the first key's (no live lane reads them)."""
        with self._lock:
            have = {ski: self._key_table_cache[ski] for ski in skis
                    if ski in self._key_table_cache}
            missing = [i for i, ski in enumerate(skis) if ski not in have]
            if missing:
                built = pk.key_tables(self._tensor(kx[:, missing]),
                                      self._tensor(ky[:, missing]))
                self.launches["p256_key_tables"] += 1  # device_inputs: the card only
                if len(self._key_table_cache) + len(missing) > self.KEY_TABLE_CACHE:
                    self._key_table_cache.clear()
                for j, i in enumerate(missing):
                    have[skis[i]] = self._key_table_cache[skis[i]] = built[j]
        cols = [have[ski] for ski in skis]
        return torch.stack(cols + cols[:1] * (kx.shape[1] - len(cols)))

    def device_inputs(self, prep, limbs, size: int):
        """The kernel wrapper and its device tensors for one launch, with the
        lanes padded to `size` (dead lanes: valid_in False). On the card the
        bytes route's wrapper comes with the key columns' cached combs."""
        if prep is not None:
            e_bytes, r_bytes, s_bytes, kx, ky, idx, skis, ok = prep
            fn = pk.verify_batch_bytes
            if self.device.type == "cuda" and skis:
                fn = functools.partial(fn, tables=self.key_tables(skis, kx, ky))
            return fn, [
                self._tensor(_pad(e_bytes, size)),
                self._tensor(_pad(r_bytes, size)),
                self._tensor(_pad(s_bytes, size)),
                self._tensor(kx),
                self._tensor(ky),
                self._tensor(_pad(idx, size)),
                self._tensor(_pad(ok, size)),
            ]
        *cols, ok = limbs
        return pk.verify_batch, [
            *(self._tensor(_pad(c, size, axis=1)) for c in cols),
            self._tensor(_pad(ok, size)),
        ]

    def _launch(self, prep, limbs, size: int) -> torch.Tensor:
        fn, args = self.device_inputs(prep, limbs, size)
        out = fn(*args)
        self._count("p256_verify_bytes" if prep is not None else "p256_verify_limbs")
        return out

    def _resolver(self, out: torch.Tensor, n: int):
        """Copy the mask to pinned host memory behind the launch and return
        a resolver that waits for that copy alone."""
        if self.device.type == "cpu":
            verdicts = out[:n].tolist()
            return lambda: verdicts
        host = torch.empty(out.shape, dtype=torch.bool, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def resolve() -> List[bool]:
            done.synchronize()
            return host[:n].tolist()

        return resolve

    # -- the SPI -----------------------------------------------------------

    def batch_verify_async(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ):
        """Launch the batch WITHOUT waiting: returns a resolver
        () -> List[bool], so a caller can prepare the next batch on the host
        while the device verifies this one."""
        n = len(signatures)
        if n == 0:
            return lambda: []
        prep, limbs = self.prep_bytes(keys, signatures, digests)
        return self._resolver(self._launch(prep, limbs, _bucket(n)), n)

    def batch_verify(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ) -> List[bool]:
        return self.batch_verify_async(keys, signatures, digests)()

    def verify(self, key: ECDSAPublicKey, signature: bytes, digest: bytes) -> bool:
        parse_and_precheck(signature)  # raises VerifyError like Fabric
        e = p256.hash_to_int(digest).to_bytes(32, "big")
        prep, limbs = self.prep_bytes([key], [signature], [e])
        return self._resolver(self._launch(prep, limbs, 1), 1)()[0]
