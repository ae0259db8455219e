"""MVCC validation on the card: the K5/K6 fixpoint kernels and their validators.

The host oracle (`mvcc.Validator`) mirrors the reference's sequential
apply-as-you-go scan (core/ledger/kvledger/txmgmt/validation/
validator.go:82-281): a read conflicts if the committed version differs
from the read version, or if ANY earlier *valid* tx in the block wrote the
key. This module re-expresses the "earlier valid" clause as a Jacobi
fixpoint:

  valid⁰[t]   = incoming-VALID[t] ∧ all committed-version checks pass
  validⁱ⁺¹[t] = valid⁰[t] ∧ ¬∃ read (t,k): min{u : u writes k, validⁱ[u]} < t

Tx t depends only on txs u < t, so the sweep converges to the unique
sequential answer in at most T + 1 sweeps (in real blocks, 2-3).

`resolve` (K5) and `resolve_resident` (K6) are the wrappers of the
kernels of `csrc/mvcc_resolve.cu`, which replace the JAX package's jitted
`_resolve` and `_resolve_resident`. Given CUDA tensors they launch on the
current stream and do not synchronize; given CPU tensors they run the plain
versions `resolve_ref` / `resolve_resident_ref`. Anything else raises;
there is no fallback. Each has two routes, chosen by the block's size
alone (`resolve_route`, `resident_route`): a shared route
(`mvcc_resolve`, `mvcc_resolve_resident`), its scratch in shared memory
and its columns in registers, for a block within `resolve_fits` /
`resident_fits` (config #4's and the 1M-key chain's blocks), and a global
route (`mvcc_resolve_global`, `mvcc_resolve_resident_global`), its
scratch in device memory, for any other. They take exact sizes: the
power-of-two buckets of
the JAX package exist so that XLA reuses a compiled program, and a CUDA
kernel needs none. Each returns the (T,) validity mask and a (1,) int32
status: the number of sweeps, or a negative code that `converged_sweeps`
turns into an error once the caller has the status on the host.

`DeviceValidator` and `ResidentDeviceValidator` keep the JAX package's API,
encode passes, host route for range queries and metadata writes, slot
seeding, capacity doubling and generation-stamp checks. They run on `cuda`
unless constructed with `device="cpu"`.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabric_tpu_torch.common.txflags import TxValidationCode
from fabric_tpu_torch.ledger.mvcc import Validator
from fabric_tpu_torch.ledger.rwset import TxRwSet, Version
from fabric_tpu_torch.ledger.statedb import HashedUpdateBatch, UpdateBatch, VersionedDB
from fabric_tpu_torch.ops import cudalib

logger = logging.getLogger("fabric_tpu_torch.mvcc_device")

_NO_VERSION = (-1, -1)  # sentinel for "key absent" (None version)
_INT32_MAX = 2**31 - 1

# Kernel launches per wrapper, counted where they launch (never for the
# plain versions).
LAUNCHES: Dict[str, int] = {"mvcc_resolve": 0, "mvcc_resolve_global": 0,
                            "mvcc_resolve_resident": 0, "mvcc_resolve_resident_global": 0}

# The shared routes (csrc/mvcc_resolve.cu resolve_fits, resident_fits): a
# block of RESIDENT_THREADS threads holding up to RESIDENT_COLS reads each
# in registers, tx ids and sweep stamps in 16 bits, and 4 bytes a key (K6:
# 12), 4 a write and 5 a transaction (and 16) of shared memory within the
# 232,448 bytes a block may have.
RESIDENT_THREADS = 1024
RESIDENT_COLS = 12
RESIDENT_T_MAX = 65532
RESIDENT_SHARED_MAX = 232448
RESOLVE_STAMPS = 16


def _shared_fits(n_reads: int, n_writes: int, num_txs: int, num_keys: int,
                 shared_bytes: int) -> bool:
    cols = RESIDENT_THREADS * RESIDENT_COLS
    return (n_reads <= cols and n_writes <= cols and num_txs <= RESIDENT_T_MAX
            and num_keys < 1 << 16 and shared_bytes <= RESIDENT_SHARED_MAX)


def resolve_shared_bytes(num_txs: int, num_keys: int, n_writes: int) -> int:
    return 4 * num_keys + 4 * n_writes + 5 * num_txs + 16


def resolve_fits(n_reads: int, n_writes: int, num_txs: int, num_keys: int) -> bool:
    return _shared_fits(n_reads, n_writes, num_txs, num_keys,
                        resolve_shared_bytes(num_txs, num_keys, n_writes))


def resolve_route(n_reads: int, n_writes: int, num_txs: int, num_keys: int) -> str:
    """The K5 kernel a block's sizes select: "mvcc_resolve" (shared
    memory) or "mvcc_resolve_global" (device memory)."""
    if resolve_fits(n_reads, n_writes, num_txs, num_keys):
        return "mvcc_resolve"
    return "mvcc_resolve_global"


def resident_shared_bytes(num_txs: int, num_keys: int, n_writes: int) -> int:
    return 12 * num_keys + 4 * n_writes + 5 * num_txs + 16


def resident_fits(n_reads: int, n_writes: int, num_txs: int, num_keys: int) -> bool:
    return _shared_fits(n_reads, n_writes, num_txs, num_keys,
                        resident_shared_bytes(num_txs, num_keys, n_writes))


def resident_route(n_reads: int, n_writes: int, num_txs: int, num_keys: int) -> str:
    """The K6 kernel a block's sizes select: "mvcc_resolve_resident"
    (shared memory) or "mvcc_resolve_resident_global" (device memory)."""
    if resident_fits(n_reads, n_writes, num_txs, num_keys):
        return "mvcc_resolve_resident"
    return "mvcc_resolve_resident_global"

# status codes written by the kernels (and the plain versions)
NOT_CONVERGED = -1
INDEX_OUT_OF_RANGE = -2


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def resolve_ref(
    r_tx: torch.Tensor,
    r_key: torch.Tensor,
    r_static_bad: torch.Tensor,
    w_tx: torch.Tensor,
    w_key: torch.Tensor,
    num_txs: int,
    num_keys: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: the same sweeps with scatter_reduce_, on any device."""
    device = r_tx.device
    status = torch.zeros(1, dtype=torch.int32, device=device)
    if any(
        t.numel() and (int(t.min()) < 0 or int(t.max()) >= bound)
        for t, bound in ((r_tx, num_txs), (r_key, num_keys), (w_tx, num_txs), (w_key, num_keys))
    ):
        status[0] = INDEX_OUT_OF_RANGE
        return torch.zeros(num_txs, dtype=torch.bool, device=device), status
    r_tx_l, r_key_l = r_tx.long(), r_key.long()
    w_tx_l, w_key_l = w_tx.long(), w_key.long()
    base = torch.ones(num_txs, dtype=torch.bool, device=device)
    base[r_tx_l[r_static_bad]] = False
    valid = base.clone()
    sweeps = 0
    while True:
        sweeps += 1
        live = torch.where(valid[w_tx_l], w_tx, torch.full_like(w_tx, _INT32_MAX))
        min_writer = torch.full((num_keys,), _INT32_MAX, dtype=torch.int32, device=device)
        min_writer.scatter_reduce_(0, w_key_l, live, "amin", include_self=True)
        read_bad = (min_writer[r_key_l] < r_tx).to(torch.int32)
        bad = torch.zeros(num_txs, dtype=torch.int32, device=device)
        bad.scatter_reduce_(0, r_tx_l, read_bad, "amax", include_self=True)
        new = base & (bad == 0)
        if torch.equal(new, valid):
            break
        valid = new
        if sweeps > num_txs:
            status[0] = NOT_CONVERGED
            return valid, status
    status[0] = sweeps
    return valid, status


def _version_key(ver: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of signed (block, tx) rows."""
    return ver[:, 0].long() * (1 << 32) + (ver[:, 1].long() + (1 << 31))


def resolve_resident_ref(
    versions: torch.Tensor,
    init_idx: torch.Tensor,
    init_ver: torch.Tensor,
    r_gid: torch.Tensor,
    r_ver: torch.Tensor,
    r_tx: torch.Tensor,
    r_key: torch.Tensor,
    w_tx: torch.Tensor,
    w_key: torch.Tensor,
    w_gid: torch.Tensor,
    w_ver: torch.Tensor,
    num_txs: int,
    num_keys: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version; updates `versions` in place, as the kernel does."""
    cap = versions.shape[0]
    keep = (init_idx >= 0) & (init_idx < cap)
    versions[init_idx[keep].long()] = init_ver[keep]
    committed = versions[r_gid.clamp(0, cap - 1).long()]
    static_bad = (committed != r_ver).any(dim=1)
    valid, status = resolve_ref(r_tx, r_key, static_bad, w_tx, w_key, num_txs, num_keys)
    if int(status[0]) < 0:
        return valid, status
    # commit: the LAST valid writer per key wins (tx order = index order);
    # among its lanes on one slot the smallest version (a delete) wins
    w_key_l = w_key.long()
    live = valid[w_tx.long()]
    writer = torch.where(live, w_tx, torch.full_like(w_tx, -1))
    last = torch.full((num_keys,), -1, dtype=torch.int32, device=versions.device)
    last.scatter_reduce_(0, w_key_l, writer, "amax", include_self=True)
    is_last = live & (w_tx == last[w_key_l]) & (w_gid >= 0) & (w_gid < cap)
    vkey = _version_key(w_ver)
    best = torch.full((num_keys,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=versions.device)
    best.scatter_reduce_(0, w_key_l[is_last], vkey[is_last], "amin", include_self=True)
    win = is_last & (vkey == best[w_key_l])
    versions[w_gid[win].long()] = w_ver[win]
    return valid, status


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cudalib.load("mvcc_resolve")
    lib.mvcc_resolve_launch.argtypes = [_P] * 5 + [_I] * 4 + [_P] * 4
    lib.mvcc_resolve_launch.restype = _I
    lib.mvcc_resolve_global_launch.argtypes = [_P] * 5 + [_I] * 4 + [_P] * 6
    lib.mvcc_resolve_global_launch.restype = _I
    lib.mvcc_resolve_resident_launch.argtypes = (
        [_P, _I, _P, _P, _I] + [_P] * 8 + [_I] * 4 + [_P] * 3
    )
    lib.mvcc_resolve_resident_launch.restype = _I
    lib.mvcc_resolve_resident_stamped_launch.argtypes = (
        [_P, _I, _P, _P, _I] + [_P] * 8 + [_I] * 4 + [_P] * 4
    )
    lib.mvcc_resolve_resident_stamped_launch.restype = _I
    lib.mvcc_resolve_resident_global_launch.argtypes = (
        [_P, _I, _P, _P, _I] + [_P] * 8 + [_I] * 4 + [_P] * 8
    )
    lib.mvcc_resolve_resident_global_launch.restype = _I
    return lib


def _launch_check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _sizes(num_txs: int, num_keys: int) -> None:
    if not 0 <= num_txs <= _INT32_MAX or not 0 <= num_keys <= _INT32_MAX:
        raise ValueError(f"num_txs {num_txs} and num_keys {num_keys} must fit int32")


def resolve(
    r_tx: torch.Tensor,
    r_key: torch.Tensor,
    r_static_bad: torch.Tensor,
    w_tx: torch.Tensor,
    w_key: torch.Tensor,
    num_txs: int,
    num_keys: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (R,) int32 r_tx, r_key, (R,) bool r_static_bad, (W,) int32 w_tx,
    w_key -> ((num_txs,) bool valid, (1,) int32 status). The kernel is the
    one `resolve_route` names for the sizes: shared memory for a block
    within `resolve_fits`, device memory for any other; each counts its own
    launches."""
    args = (r_tx, r_key, r_static_bad, w_tx, w_key)
    device, n_r, n_w = _resolve_checks(*args, num_txs=num_txs, num_keys=num_keys)
    if not cudalib.kernel_device(device, "MVCC"):
        return resolve_ref(*args, num_txs, num_keys)
    return _launch_resolve(resolve_route(n_r, n_w, num_txs, num_keys), *args,
                           num_txs=num_txs, num_keys=num_keys)


def launch_resolve(route: str, *args, num_txs: int, num_keys: int):
    """K5's kernel `route` ("mvcc_resolve" or "mvcc_resolve_global") on
    CUDA tensors in `resolve`'s layout, whatever the sizes would pick: the
    entry through which `chip_smoke.py` holds each route to the plain
    version at one shape. The shared route raises on a block past
    `resolve_fits`."""
    device, _n_r, _n_w = _resolve_checks(*args, num_txs=num_txs, num_keys=num_keys)
    if device.type != "cuda":
        raise ValueError("launch_resolve runs a kernel: give it CUDA tensors")
    return _launch_resolve(route, *args, num_txs=num_txs, num_keys=num_keys)


def resolve_stamped(*args, num_txs: int, num_keys: int):
    """K5's shared route on CUDA tensors in `resolve`'s layout, with thread
    0's SM clock (clock64) stamps: (valid, status, (16,) int64) in the
    kernel's slots: the block's start (0), the scratch's barrier (1), each
    half of thread 0's columns in (2, 3), the columns' barrier (4), each
    barrier of sweeps 0-4 (5-14: writers, readers; 0 for a sweep not run)
    and the end (15). The probe behind the split of K5's time; it
    counts as a launch of `mvcc_resolve`."""
    device, _n_r, _n_w = _resolve_checks(*args, num_txs=num_txs, num_keys=num_keys)
    if device.type != "cuda":
        raise ValueError("resolve_stamped reads the card's clock: give it CUDA tensors")
    stamps = torch.zeros(RESOLVE_STAMPS, dtype=torch.int64, device=device)
    valid, status = _launch_resolve("mvcc_resolve", *args, num_txs=num_txs, num_keys=num_keys,
                                    stamps=stamps)
    return valid, status, stamps


def _resolve_checks(r_tx, r_key, r_static_bad, w_tx, w_key, *, num_txs: int, num_keys: int):
    device = r_tx.device
    n_r = r_tx.shape[0] if r_tx.dim() == 1 else -1
    n_w = w_tx.shape[0] if w_tx.dim() == 1 else -1
    for name, t in (("r_tx", r_tx), ("r_key", r_key)):
        cudalib.check_tensor(name, t, torch.int32, (n_r,), device)
    cudalib.check_tensor("r_static_bad", r_static_bad, torch.bool, (n_r,), device)
    for name, t in (("w_tx", w_tx), ("w_key", w_key)):
        cudalib.check_tensor(name, t, torch.int32, (n_w,), device)
    _sizes(num_txs, num_keys)
    return device, n_r, n_w


def _launch_resolve(route, r_tx, r_key, r_static_bad, w_tx, w_key, *, num_txs: int,
                    num_keys: int, stamps: Optional[torch.Tensor] = None):
    device = r_tx.device
    n_r, n_w = r_tx.shape[0], w_tx.shape[0]
    valid = torch.empty(num_txs, dtype=torch.bool, device=device)
    status = torch.empty(1, dtype=torch.int32, device=device)
    cols = (r_tx.data_ptr(), r_key.data_ptr(), r_static_bad.data_ptr(), w_tx.data_ptr(),
            w_key.data_ptr(), n_r, n_w, num_txs, num_keys)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if route == "mvcc_resolve":
            rc = _lib().mvcc_resolve_launch(
                *cols, valid.data_ptr(), status.data_ptr(),
                None if stamps is None else stamps.data_ptr(), stream)
        elif route == "mvcc_resolve_global":
            min_writer = torch.empty(num_keys, dtype=torch.int32, device=device)
            bad = torch.empty(num_txs, dtype=torch.int32, device=device)
            base = torch.empty(num_txs, dtype=torch.uint8, device=device)
            rc = _lib().mvcc_resolve_global_launch(
                *cols, min_writer.data_ptr(), bad.data_ptr(), base.data_ptr(),
                valid.data_ptr(), status.data_ptr(), stream)
        else:
            raise ValueError(f"no K5 route {route!r}")
    _launch_check(route, rc)
    return valid, status


def resolve_resident(
    versions: torch.Tensor,
    init_idx: torch.Tensor,
    init_ver: torch.Tensor,
    r_gid: torch.Tensor,
    r_ver: torch.Tensor,
    r_tx: torch.Tensor,
    r_key: torch.Tensor,
    w_tx: torch.Tensor,
    w_key: torch.Tensor,
    w_gid: torch.Tensor,
    w_ver: torch.Tensor,
    num_txs: int,
    num_keys: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (cap, 2) int32 versions; (I,) init_idx, (I, 2) init_ver; (R,)
    r_gid, (R, 2) r_ver, (R,) r_tx, r_key; (W,) w_tx, w_key, w_gid, (W, 2)
    w_ver, all int32 -> ((num_txs,) bool valid, (1,) int32 status).

    The version table is updated IN PLACE (init scatter, then the commit
    scatter), where the JAX program donates it and returns a new one. After
    a launch whose status is negative, or a failed launch, its contents are
    unreliable and the caller drops it. The kernel is the one
    `resident_route` names for the sizes: shared memory for a block within
    `resident_fits`, device memory for any other; each counts its own
    launches."""
    args = (versions, init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx, w_key, w_gid, w_ver)
    device, n_r, n_w = _resident_checks(*args, num_txs=num_txs, num_keys=num_keys)
    if not cudalib.kernel_device(device, "MVCC"):
        return resolve_resident_ref(*args, num_txs, num_keys)
    return _launch_resident(resident_route(n_r, n_w, num_txs, num_keys), *args,
                            num_txs=num_txs, num_keys=num_keys)


def launch_resident(route: str, *args, num_txs: int, num_keys: int):
    """K6's kernel `route` ("mvcc_resolve_resident" or
    "mvcc_resolve_resident_global") on CUDA tensors in `resolve_resident`'s
    layout, whatever the sizes would pick: the entry through which
    `chip_smoke.py` holds each route to the plain version at one shape. The
    shared route raises on a block past `resident_fits`."""
    device, _n_r, _n_w = _resident_checks(*args, num_txs=num_txs, num_keys=num_keys)
    if device.type != "cuda":
        raise ValueError("launch_resident runs a kernel: give it CUDA tensors")
    return _launch_resident(route, *args, num_txs=num_txs, num_keys=num_keys)


def resolve_resident_stamped(*args, num_txs: int, num_keys: int):
    """K6's shared route on CUDA tensors in `resolve_resident`'s layout, with
    thread 0's SM clock (clock64) stamps: (valid, status, (18,) int64) in
    the kernel's slots: the block's start (0), the columns' barrier (1),
    the versions' check (2), each barrier of sweeps 0-4 (3-12: writers,
    readers; 0 for a sweep not run), the commit's two barriers and the end
    (13-15), and thread 0's reads and writes loaded (16, 17). The probe
    behind the split of K6's time; it counts as a launch of
    `mvcc_resolve_resident`."""
    device, n_r, n_w = _resident_checks(*args, num_txs=num_txs, num_keys=num_keys)
    if device.type != "cuda":
        raise ValueError("resolve_resident_stamped reads the card's clock: give it CUDA tensors")
    versions, init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx, w_key, w_gid, w_ver = args
    valid = torch.empty(num_txs, dtype=torch.bool, device=device)
    status = torch.empty(1, dtype=torch.int32, device=device)
    stamps = torch.zeros(18, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = _lib().mvcc_resolve_resident_stamped_launch(
            versions.data_ptr(), versions.shape[0], init_idx.data_ptr(), init_ver.data_ptr(),
            init_idx.shape[0], r_gid.data_ptr(), r_ver.data_ptr(), r_tx.data_ptr(),
            r_key.data_ptr(), w_tx.data_ptr(), w_key.data_ptr(), w_gid.data_ptr(),
            w_ver.data_ptr(), n_r, n_w, num_txs, num_keys, valid.data_ptr(),
            status.data_ptr(), stamps.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _launch_check("mvcc_resolve_resident", rc)
    return valid, status, stamps


def _resident_checks(versions, init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx, w_key,
                     w_gid, w_ver, *, num_txs: int, num_keys: int):
    device = versions.device
    cap = versions.shape[0] if versions.dim() == 2 else -1
    n_i = init_idx.shape[0] if init_idx.dim() == 1 else -1
    n_r = r_tx.shape[0] if r_tx.dim() == 1 else -1
    n_w = w_tx.shape[0] if w_tx.dim() == 1 else -1
    if cap < 1:
        raise ValueError("versions must be a (cap, 2) table with cap >= 1")
    checks = (
        ("versions", versions, (cap, 2)), ("init_idx", init_idx, (n_i,)),
        ("init_ver", init_ver, (n_i, 2)), ("r_gid", r_gid, (n_r,)), ("r_ver", r_ver, (n_r, 2)),
        ("r_tx", r_tx, (n_r,)), ("r_key", r_key, (n_r,)), ("w_tx", w_tx, (n_w,)),
        ("w_key", w_key, (n_w,)), ("w_gid", w_gid, (n_w,)), ("w_ver", w_ver, (n_w, 2)),
    )
    for name, t, shape in checks:
        cudalib.check_tensor(name, t, torch.int32, shape, device)
    _sizes(num_txs, num_keys)
    return device, n_r, n_w


def _launch_resident(route, versions, init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx,
                     w_key, w_gid, w_ver, *, num_txs: int, num_keys: int):
    device = versions.device
    n_r, n_w = r_tx.shape[0], w_tx.shape[0]
    valid = torch.empty(num_txs, dtype=torch.bool, device=device)
    status = torch.empty(1, dtype=torch.int32, device=device)
    cols = (
        versions.data_ptr(), versions.shape[0], init_idx.data_ptr(), init_ver.data_ptr(),
        init_idx.shape[0], r_gid.data_ptr(), r_ver.data_ptr(), r_tx.data_ptr(),
        r_key.data_ptr(), w_tx.data_ptr(), w_key.data_ptr(), w_gid.data_ptr(),
        w_ver.data_ptr(), n_r, n_w, num_txs, num_keys,
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if route == "mvcc_resolve_resident":
            rc = _lib().mvcc_resolve_resident_launch(
                *cols, valid.data_ptr(), status.data_ptr(), stream)
        elif route == "mvcc_resolve_resident_global":
            static_bad = torch.empty(n_r, dtype=torch.uint8, device=device)
            min_writer = torch.empty(num_keys, dtype=torch.int32, device=device)
            best = torch.empty(num_keys, dtype=torch.int64, device=device)
            bad = torch.empty(num_txs, dtype=torch.int32, device=device)
            base = torch.empty(num_txs, dtype=torch.uint8, device=device)
            rc = _lib().mvcc_resolve_resident_global_launch(
                *cols, static_bad.data_ptr(), min_writer.data_ptr(), best.data_ptr(),
                bad.data_ptr(), base.data_ptr(), valid.data_ptr(), status.data_ptr(), stream)
        else:
            raise ValueError(f"no K6 route {route!r}")
    _launch_check(route, rc)
    return valid, status


def converged_sweeps(status: torch.Tensor) -> int:
    """The sweep count from a resolver's status; raises if it did not converge."""
    code = int(status[0])
    if code == NOT_CONVERGED:
        raise RuntimeError("MVCC fixpoint did not converge within T + 1 sweeps")
    if code == INDEX_OUT_OF_RANGE:
        raise ValueError("MVCC columns hold a tx or key index outside [0, T) or [0, K)")
    if code < 1:
        raise RuntimeError(f"MVCC resolver returned status {code}")
    return code


# ---------------------------------------------------------------------------
# Validators
# ---------------------------------------------------------------------------


def _i32(vals, device: torch.device, shape=None) -> torch.Tensor:
    a = np.asarray(vals, dtype=np.int32)
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(a).to(device)


class DeviceValidator:
    """Drop-in for mvcc.Validator with the K5 kernel behind it.

    Correctness contract: identical codes and update batches to the host
    oracle for every block. `last_path` says which route the last block
    took ("device" or "host"); `last_sweeps` the fixpoint's sweep count and
    `last_ms` the host-clock split of the last device block (encode, launch
    and wait, emit)."""

    def __init__(self, db: VersionedDB, device=None):
        self.db = db
        self.device = cudalib.resolve_device(device, "MVCC")
        self._host = Validator(db)
        self.last_path = "host"
        self.last_sweeps = 0
        self.last_ms: Dict[str, float] = {}

    # -- encoding ---------------------------------------------------------
    def _encode(
        self,
        tx_rwsets: Sequence[Optional[TxRwSet]],
        incoming_codes: Sequence[TxValidationCode],
    ):
        """Flatten the block into read/write columns, or None when a shape
        outside the device scope (range query, metadata write) appears in
        a tx that would actually be validated."""
        key_ids: dict = {}
        r_tx: List[int] = []
        r_key: List[int] = []
        r_bad: List[bool] = []
        w_tx: List[int] = []
        w_key: List[int] = []

        def kid(k) -> int:
            i = key_ids.get(k)
            if i is None:
                i = len(key_ids)
                key_ids[k] = i
            return i

        for t, (rwset, code) in enumerate(zip(tx_rwsets, incoming_codes)):
            if code != TxValidationCode.VALID or rwset is None:
                continue
            for ns_rw in rwset.ns_rw_sets:
                if ns_rw.range_queries or ns_rw.metadata_writes:
                    return None
                ns = ns_rw.namespace
                for read in ns_rw.reads:
                    committed = self.db.get_version(ns, read.key)
                    r_tx.append(t)
                    r_key.append(kid((ns, "", read.key)))
                    r_bad.append(committed != read.version)
                for w in ns_rw.writes:
                    w_tx.append(t)
                    w_key.append(kid((ns, "", w.key)))
                for coll in ns_rw.coll_hashed:
                    if coll.metadata_writes:
                        return None
                    cn = coll.collection_name
                    for hread in coll.hashed_reads:
                        committed = self.db.get_key_hash_version(ns, cn, hread.key_hash)
                        r_tx.append(t)
                        r_key.append(kid((ns, cn, hread.key_hash)))
                        r_bad.append(committed != hread.version)
                    for hw in coll.hashed_writes:
                        w_tx.append(t)
                        w_key.append(kid((ns, cn, hw.key_hash)))
        return r_tx, r_key, r_bad, w_tx, w_key, len(key_ids)

    # -- public API (mirrors mvcc.Validator) ------------------------------
    def validate_and_prepare_batch(
        self,
        block_num: int,
        tx_rwsets: Sequence[Optional[TxRwSet]],
        incoming_codes: Sequence[TxValidationCode],
        do_mvcc: bool = True,
    ) -> Tuple[List[TxValidationCode], UpdateBatch, HashedUpdateBatch]:
        if not do_mvcc:
            return self._host.validate_and_prepare_batch(
                block_num, tx_rwsets, incoming_codes, do_mvcc=False
            )
        t0 = time.perf_counter()
        enc = self._encode(tx_rwsets, incoming_codes)
        if enc is None:
            self.last_path = "host"
            return self._host.validate_and_prepare_batch(block_num, tx_rwsets, incoming_codes)
        self.last_path = "device"
        r_tx, r_key, r_bad, w_tx, w_key, n_keys = enc
        dev = self.device
        cols = (
            _i32(r_tx, dev), _i32(r_key, dev),
            torch.from_numpy(np.asarray(r_bad, dtype=np.bool_)).to(dev),
            _i32(w_tx, dev), _i32(w_key, dev),
        )
        t1 = time.perf_counter()
        valid, status = resolve(*cols, num_txs=len(tx_rwsets), num_keys=n_keys)
        valid, status = valid.cpu(), status.cpu()
        self.last_sweeps = converged_sweeps(status)
        t2 = time.perf_counter()
        out = self._emit(valid.tolist(), tx_rwsets, incoming_codes, block_num)
        self.last_ms = {
            "encode": (t1 - t0) * 1e3,
            "launch": (t2 - t1) * 1e3,
            "emit": (time.perf_counter() - t2) * 1e3,
        }
        return out

    def _emit(
        self, valid, tx_rwsets, incoming_codes, block_num
    ) -> Tuple[List[TxValidationCode], UpdateBatch, HashedUpdateBatch]:
        """Device verdicts -> (codes, update batches); shared with the
        resident variant so code-mapping fixes cannot diverge."""
        updates = UpdateBatch()
        hashed_updates = HashedUpdateBatch()
        out: List[TxValidationCode] = []
        for t, (rwset, code) in enumerate(zip(tx_rwsets, incoming_codes)):
            if code != TxValidationCode.VALID or rwset is None:
                out.append(code)
                continue
            if valid[t]:
                out.append(TxValidationCode.VALID)
                self._host._apply_write_set(
                    rwset, Version(block_num, t), updates, hashed_updates
                )
            else:
                out.append(TxValidationCode.MVCC_READ_CONFLICT)
        return out, updates, hashed_updates


class ResidentDeviceValidator(DeviceValidator):
    """DeviceValidator variant that keeps the (ns, coll, key) -> version
    table RESIDENT in device memory across blocks: the per-block host
    encode pass no longer probes db.get_version per read; the
    committed-version checks, the fixpoint and the version-table update are
    one K6 launch.

    Coherence contract: all commits for the tracked namespaces flow through
    validate_and_prepare_batch (the kvledger path). Blocks that take the
    host route (range queries / metadata writes) refresh the resident
    entries of the keys they wrote via the pending init queue. State
    mutated BEHIND the validator's back (rollback + re-commit, rebuild,
    clear) is detected via the db's ``state_generation`` stamp, checked
    BEFORE the table is trusted and AGAIN after the launch: a stale table
    is dropped and the block re-resolves against live state (the host
    oracle for the mid-block race, a fresh table otherwise). A mask is
    never emitted from a dead table generation; ``invalidate()`` remains
    the manual seam.

    A key's slot is assigned on first sight and its committed version
    seeded from the host db ONCE (one probe per key lifetime).

    One deliberate departure from the JAX package: there, any exception
    from the device dispatch drops the residency and serves the block from
    the host oracle. Here a failed launch, copy or fixpoint drops the
    residency (the table is updated in place and no longer trusted) and
    RAISES: a device fault is never hidden behind a host verdict."""

    def __init__(self, db: VersionedDB, capacity: int = 1 << 17, device=None):
        super().__init__(db, device=device)
        self._cap = capacity
        self._index: dict = {}  # (ns, coll, key) -> slot
        self._dev_versions: Optional[torch.Tensor] = None  # created on first device block
        self._pending_init: List[Tuple[int, Tuple[int, int]]] = []
        # generation stamp: the db.state_generation this table was built
        # against; None = no live table
        self._table_generation: Optional[int] = None
        self.invalidations = 0

    # -- coherence ---------------------------------------------------------
    def _db_generation(self) -> int:
        return getattr(self.db, "state_generation", 0)

    def invalidate(self) -> None:
        """Drop the resident table (state changed behind our back)."""
        self._index.clear()
        self._dev_versions = None
        self._pending_init.clear()
        self._table_generation = None

    def _note_stale(self, block_num: int, when: str) -> None:
        self.invalidations += 1
        logger.warning(
            "resident MVCC table generation %s went stale %s block %d "
            "(db generation %d): dropping residency and re-resolving "
            "against live state",
            self._table_generation, when, block_num, self._db_generation(),
        )
        self.invalidate()

    def _note_batches(self, updates: UpdateBatch, hashed: HashedUpdateBatch):
        """Queue refreshes for host-committed writes of tracked keys."""
        for (ns, key), entry in updates.items():
            slot = self._index.get((ns, "", key))
            if slot is not None:
                ver = (
                    _NO_VERSION
                    if entry.value is None
                    else (entry.version.block_num, entry.version.tx_num)
                )
                self._pending_init.append((slot, ver))
        for (ns, coll, key_hash), entry in hashed.items():
            slot = self._index.get((ns, coll, key_hash))
            if slot is not None:
                ver = (
                    _NO_VERSION
                    if entry.value is None
                    else (entry.version.block_num, entry.version.tx_num)
                )
                self._pending_init.append((slot, ver))

    def _slot(self, k, inits: List[Tuple[int, Tuple[int, int]]]) -> int:
        slot = self._index.get(k)
        if slot is None:
            slot = len(self._index)
            self._index[k] = slot
            ns, coll, key = k
            committed = (
                self.db.get_key_hash_version(ns, coll, key)
                if coll
                else self.db.get_version(ns, key)
            )
            inits.append(
                (
                    slot,
                    (committed.block_num, committed.tx_num)
                    if committed is not None
                    else _NO_VERSION,
                )
            )
        return slot

    # -- public API --------------------------------------------------------
    def validate_and_prepare_batch(
        self,
        block_num: int,
        tx_rwsets: Sequence[Optional[TxRwSet]],
        incoming_codes: Sequence[TxValidationCode],
        do_mvcc: bool = True,
    ) -> Tuple[List[TxValidationCode], UpdateBatch, HashedUpdateBatch]:
        if not do_mvcc:
            out = self._host.validate_and_prepare_batch(
                block_num, tx_rwsets, incoming_codes, do_mvcc=False
            )
            # commits still flow: tracked resident entries must refresh
            self._note_batches(out[1], out[2])
            return out
        # generation check (per block, BEFORE the table is trusted)
        gen_at_start = self._db_generation()
        if self._dev_versions is not None and self._table_generation != gen_at_start:
            self._note_stale(block_num, "before")
        t0 = time.perf_counter()
        enc = self._encode_resident(tx_rwsets, incoming_codes, block_num)
        if enc is None:
            self.last_path = "host"
            out = self._host.validate_and_prepare_batch(block_num, tx_rwsets, incoming_codes)
            self._note_batches(out[1], out[2])
            return out
        self.last_path = "device"
        (r_tx, r_key, r_gid, r_ver, w_tx, w_key, w_gid, w_ver, n_keys, inits) = enc
        # dedupe by slot, LATEST entry wins: two queued refreshes of the
        # same key must not let the stale one survive
        merged = {}
        for slot, v in self._pending_init + inits:
            merged[slot] = v
        inits = list(merged.items())
        self._pending_init = []

        # capacity growth (doubling) before the launch that needs it:
        # resolve the final capacity on host first, then extend the table
        # once
        dev = self.device
        old_cap = self._cap
        while len(self._index) > self._cap:
            self._cap *= 2
        if self._dev_versions is not None and self._cap > old_cap:
            self._dev_versions = torch.cat([
                self._dev_versions,
                torch.full((self._cap - old_cap, 2), -1, dtype=torch.int32, device=dev),
            ])
        if self._dev_versions is None:
            self._dev_versions = torch.full((self._cap, 2), -1, dtype=torch.int32, device=dev)
        # stamp the table with the generation its seeds were read under
        self._table_generation = gen_at_start

        args = (
            _i32([i for i, _v in inits], dev), _i32([v for _i, v in inits], dev, (-1, 2)),
            _i32(r_gid, dev), _i32(r_ver, dev, (-1, 2)), _i32(r_tx, dev), _i32(r_key, dev),
            _i32(w_tx, dev), _i32(w_key, dev), _i32(w_gid, dev), _i32(w_ver, dev, (-1, 2)),
        )
        t1 = time.perf_counter()
        try:
            valid, status = resolve_resident(
                self._dev_versions, *args, num_txs=len(tx_rwsets), num_keys=n_keys
            )
            valid, status = valid.cpu(), status.cpu()
            self.last_sweeps = converged_sweeps(status)
        except BaseException:
            # the table is updated in place: after a failed launch, copy or
            # fixpoint its contents are unreliable
            self.invalidate()
            raise
        t2 = time.perf_counter()

        if self._db_generation() != gen_at_start:
            # state mutated mid-block (between encode/launch and here): the
            # verdicts came from a DEAD table generation — discard them
            # unseen and re-resolve on the host against live state
            self._note_stale(block_num, "during")
            self.last_path = "host"
            out = self._host.validate_and_prepare_batch(block_num, tx_rwsets, incoming_codes)
            self._note_batches(out[1], out[2])
            return out

        out = self._emit(valid.tolist(), tx_rwsets, incoming_codes, block_num)
        self.last_ms = {
            "encode": (t1 - t0) * 1e3,
            "launch": (t2 - t1) * 1e3,
            "emit": (time.perf_counter() - t2) * 1e3,
        }
        return out

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def slots_used(self) -> int:
        return len(self._index)

    # -- encoding ----------------------------------------------------------
    def _encode_resident(self, tx_rwsets, incoming_codes, block_num):
        """Like DeviceValidator._encode but WITHOUT per-read host
        get_version probes: reads carry their claimed version and a global
        resident slot; the committed comparison happens on the card.
        Writes carry the version they would commit."""
        inits: List[Tuple[int, Tuple[int, int]]] = []
        local_ids: dict = {}
        r_tx: List[int] = []
        r_key: List[int] = []
        r_gid: List[int] = []
        r_ver: List[Tuple[int, int]] = []
        w_tx: List[int] = []
        w_key: List[int] = []
        w_gid: List[int] = []
        w_ver: List[Tuple[int, int]] = []

        def lid(k) -> int:
            i = local_ids.get(k)
            if i is None:
                i = len(local_ids)
                local_ids[k] = i
            return i

        def abort():
            # slots assigned during this walk stay in the index; their
            # seeds must not be lost or the slots would sit at the
            # uninitialized sentinel forever (false conflicts later)
            self._pending_init.extend(inits)
            return None

        for t, (rwset, code) in enumerate(zip(tx_rwsets, incoming_codes)):
            if code != TxValidationCode.VALID or rwset is None:
                continue
            for ns_rw in rwset.ns_rw_sets:
                if ns_rw.range_queries or ns_rw.metadata_writes:
                    return abort()
                ns = ns_rw.namespace
                for read in ns_rw.reads:
                    k = (ns, "", read.key)
                    r_tx.append(t)
                    r_key.append(lid(k))
                    r_gid.append(self._slot(k, inits))
                    v = read.version
                    r_ver.append((v.block_num, v.tx_num) if v is not None else _NO_VERSION)
                for w in ns_rw.writes:
                    k = (ns, "", w.key)
                    w_tx.append(t)
                    w_key.append(lid(k))
                    w_gid.append(self._slot(k, inits))
                    w_ver.append(_NO_VERSION if w.is_delete else (block_num, t))
                for coll in ns_rw.coll_hashed:
                    if coll.metadata_writes:
                        return abort()
                    cn = coll.collection_name
                    for hread in coll.hashed_reads:
                        k = (ns, cn, hread.key_hash)
                        r_tx.append(t)
                        r_key.append(lid(k))
                        r_gid.append(self._slot(k, inits))
                        v = hread.version
                        r_ver.append((v.block_num, v.tx_num) if v is not None else _NO_VERSION)
                    for hw in coll.hashed_writes:
                        k = (ns, cn, hw.key_hash)
                        w_tx.append(t)
                        w_key.append(lid(k))
                        w_gid.append(self._slot(k, inits))
                        w_ver.append(_NO_VERSION if hw.is_delete else (block_num, t))
        return (
            r_tx, r_key, r_gid, r_ver, w_tx, w_key, w_gid, w_ver,
            len(local_ids), inits,
        )
