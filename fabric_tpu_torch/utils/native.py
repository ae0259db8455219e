"""The port's C++ host runtime (`fabric_tpu_torch/native/*.cc`), built with
g++ on first use and bound with ctypes.

The port's counterpart of the JAX package's `utils/native.py`, over the
port's own copies of the sources: batched SHA-256 (`fn_batch_sha256`), the
strict-DER signature parse (`fn_batch_der_parse`) and the one-pass block
parse (`fn_block_*`, read by `validation/blockparse.py`). This is host
code that feeds the kernels, not a kernel.

The sources are compiled with the flags of the JAX package's
`native/Makefile` (no `-march=native`) into
`build/torch_native/fabric_native-<sha256 of the sources>.so` at the root
of the checkout: written under a temporary name, then renamed, so a process
that has the library loaded never sees it rewritten. Nothing runs at import
time.

One deliberate departure from the JAX module: that module falls back to
its Python parsers when the build or the load fails. Here a missing
compiler, a failed build or a failed load raises, so no caller runs the
Python route without asking for it by name (`crypto/sigparse.
batch_der_parse_python`, `validation/blockparse.parse_block_python`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "native"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_native"
SOURCES = ("fabric_native.cc", "blockparse.cc", "sha256c.cc")
HEADERS = ("sha256c.h",)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None

# calls of each native entry point, as the kernel wrappers count their
# launches: what a caller reads to show which parse ran
CALLS: Dict[str, int] = {"fn_batch_sha256": 0, "fn_batch_der_parse": 0, "fn_block_parse": 0}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "fn_batch_sha256": ([_U8P, _U64P, _U64P, ctypes.c_int64, _U8P], None),
    "fn_batch_der_parse": ([_U8P, _U64P, _U64P, ctypes.c_int64, _U8P, _U8P, _U8P, _U8P], None),
    "fn_block_parse": ([_U8P, _U64P, _U64P, ctypes.c_int64], ctypes.c_void_p),
    "fn_block_counts": ([ctypes.c_void_p, _I64P], None),
    "fn_block_pertx": ([ctypes.c_void_p, _I32P, _I32P, _U8P, _U64P], None),
    "fn_block_jobs": ([ctypes.c_void_p, _I64P, _I64P, _U8P, _U64P, _U64P, _U8P], None),
    "fn_block_uniq": ([ctypes.c_void_p, _U64P], None),
    "fn_block_ns": ([ctypes.c_void_p, _I64P, _U8P, _U64P], None),
    "fn_block_wkeys": ([ctypes.c_void_p, _I64P, _I64P, _U8P, _U64P, _U64P], None),
    "fn_block_free": ([ctypes.c_void_p], None),
    "fn_sha256_backend": ([], ctypes.c_int),
}


def library_path() -> Path:
    """Where the library of the current sources lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"fabric_native-{h.hexdigest()}.so"


def build() -> Path:
    """Compile the sources unless their content-addressed library exists;
    raise if there is no g++ or the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SOURCE_DIR / s) for s in SOURCES), "-ldl"]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on the native host runtime (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def sha256_backend() -> str:
    """Which SHA-256 the library runs: "libcrypto" (OpenSSL's, through
    dlopen) or "portable" (its own FIPS 180-4 code)."""
    return "libcrypto" if load().fn_sha256_backend() else "portable"


def pack(chunks: Sequence[bytes]) -> Tuple[bytes, np.ndarray, np.ndarray, np.ndarray]:
    """(joined bytes, its uint8 view (never empty), offsets, lengths)."""
    joined = b"".join(chunks)
    lens = np.fromiter((len(c) for c in chunks), dtype=np.uint64, count=len(chunks))
    offsets = np.zeros(len(chunks), dtype=np.uint64)
    if len(chunks) > 1:
        np.cumsum(lens[:-1], out=offsets[1:])
    blob = np.frombuffer(joined, dtype=np.uint8) if joined else np.zeros(1, dtype=np.uint8)
    return joined, blob, offsets, lens


def ptr(a: np.ndarray, ctype):
    """A ctypes pointer to a C-contiguous array's data."""
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("the native runtime takes C-contiguous arrays")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def batch_sha256(msgs: Sequence[bytes]) -> np.ndarray:
    """(N, 32) uint8 digests."""
    n = len(msgs)
    out = np.zeros((n, 32), dtype=np.uint8)
    if n == 0:
        return out
    lib = load()
    _, blob, offsets, lens = pack(msgs)
    lib.fn_batch_sha256(ptr(blob, ctypes.c_uint8), ptr(offsets, ctypes.c_uint64),
                        ptr(lens, ctypes.c_uint64), n, ptr(out, ctypes.c_uint8))
    CALLS["fn_batch_sha256"] += 1
    return out


def batch_der_parse(sigs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(r[N,32], s[N,32], ok[N], low_s[N]) uint8: as
    `crypto/sigparse.batch_der_parse_python`, byte for byte. A row the
    parse refuses holds r = s = 0 (`fn_batch_der_parse` leaves there what
    it had read before it refused)."""
    n = len(sigs)
    r = np.zeros((n, 32), dtype=np.uint8)
    s = np.zeros((n, 32), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    low_s = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return r, s, ok, low_s
    lib = load()
    _, blob, offsets, lens = pack(sigs)
    u8 = ctypes.c_uint8
    lib.fn_batch_der_parse(ptr(blob, u8), ptr(offsets, ctypes.c_uint64),
                           ptr(lens, ctypes.c_uint64), n, ptr(r, u8), ptr(s, u8), ptr(ok, u8),
                           ptr(low_s, u8))
    CALLS["fn_batch_der_parse"] += 1
    dead = ok == 0
    r[dead] = 0
    s[dead] = 0
    return r, s, ok, low_s


class BlockColumns(NamedTuple):
    """What `fn_block_parse` returns for a block, as numpy columns; every
    (offset, length) pair points into `buf`, the envelopes joined."""

    buf: bytes
    code: np.ndarray  # (n,) int32: a TxValidationCode, 254 for not yet validated
    header_type: np.ndarray  # (n,) int32, -1 where the header did not parse
    has_md: np.ndarray  # (n,) uint8: any metadata write
    strs: np.ndarray  # (n * 12,) uint64: channel, txid, creator, config, ns, results
    job_tx: np.ndarray  # (jobs,) int64
    job_ident: np.ndarray  # (jobs,) int64 index into uniq
    job_is_creator: np.ndarray  # (jobs,) uint8
    job_sig: np.ndarray  # (jobs * 2,) uint64
    job_digest: np.ndarray  # (jobs * 32,) uint8: SHA-256 of each job's signed bytes
    uniq: np.ndarray  # (identities * 2,) uint64
    ns_tx: np.ndarray  # (entries,) int64
    ns_writes: np.ndarray  # (entries,) uint8
    ns_str: np.ndarray  # (entries * 2,) uint64
    wk_tx: np.ndarray  # (keys,) int64
    wk_ns: np.ndarray  # (keys,) int64 index into the ns entries
    wk_hashed: np.ndarray  # (keys,) uint8
    wk_coll: np.ndarray  # (keys * 2,) uint64
    wk_key: np.ndarray  # (keys * 2,) uint64


def block_parse(datas: Sequence[bytes]) -> BlockColumns:
    """One C++ pass over every envelope of a block."""
    lib = load()
    n = len(datas)
    buf, blob, offsets, lens = pack(datas)
    u8, u64, i32, i64 = ctypes.c_uint8, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64
    h = lib.fn_block_parse(ptr(blob, u8), ptr(offsets, u64), ptr(lens, u64), n)
    if not h:
        raise RuntimeError("fn_block_parse returned no result")
    CALLS["fn_block_parse"] += 1
    try:
        counts = np.zeros(4, dtype=np.int64)
        lib.fn_block_counts(h, ptr(counts, i64))
        n_jobs, n_uniq, n_ns, n_wk = (int(x) for x in counts)

        def col(size, dtype, per=1):
            return np.zeros(max(size, 1) * per, dtype=dtype)

        code, header_type = col(n, np.int32), col(n, np.int32)
        has_md, strs = col(n, np.uint8), col(n, np.uint64, 12)
        lib.fn_block_pertx(h, ptr(code, i32), ptr(header_type, i32), ptr(has_md, u8),
                           ptr(strs, u64))
        job_tx, job_ident, job_is_creator = col(n_jobs, np.int64), col(n_jobs, np.int64), col(
            n_jobs, np.uint8)
        job_sig, job_data = col(n_jobs, np.uint64, 2), col(n_jobs, np.uint64, 2)
        job_digest = col(n_jobs, np.uint8, 32)
        if n_jobs:
            lib.fn_block_jobs(h, ptr(job_tx, i64), ptr(job_ident, i64), ptr(job_is_creator, u8),
                              ptr(job_sig, u64), ptr(job_data, u64), ptr(job_digest, u8))
        uniq = col(n_uniq, np.uint64, 2)
        if n_uniq:
            lib.fn_block_uniq(h, ptr(uniq, u64))
        ns_tx, ns_writes, ns_str = col(n_ns, np.int64), col(n_ns, np.uint8), col(
            n_ns, np.uint64, 2)
        if n_ns:
            lib.fn_block_ns(h, ptr(ns_tx, i64), ptr(ns_writes, u8), ptr(ns_str, u64))
        wk_tx, wk_ns, wk_hashed = col(n_wk, np.int64), col(n_wk, np.int64), col(n_wk, np.uint8)
        wk_coll, wk_key = col(n_wk, np.uint64, 2), col(n_wk, np.uint64, 2)
        if n_wk:
            lib.fn_block_wkeys(h, ptr(wk_tx, i64), ptr(wk_ns, i64), ptr(wk_hashed, u8),
                               ptr(wk_coll, u64), ptr(wk_key, u64))
    finally:
        lib.fn_block_free(h)
    return BlockColumns(
        buf, code[:n], header_type[:n], has_md[:n], strs[:12 * n], job_tx[:n_jobs],
        job_ident[:n_jobs], job_is_creator[:n_jobs], job_sig[:2 * n_jobs],
        job_digest[:32 * n_jobs], uniq[:2 * n_uniq], ns_tx[:n_ns], ns_writes[:n_ns],
        ns_str[:2 * n_ns], wk_tx[:n_wk], wk_ns[:n_wk], wk_hashed[:n_wk], wk_coll[:2 * n_wk],
        wk_key[:2 * n_wk])
