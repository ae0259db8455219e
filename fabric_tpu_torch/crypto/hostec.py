"""Dependency-free vectorized host ECDSA-P256 batch verification (hostec).

The port's copy of the JAX package's `crypto/hostec.py`, with its imports
pointed at the port's `common` modules; it imports neither numpy nor torch,
so its pool workers start light. The lowest fast tier of the host EC
ladder (``hostec_np`` -> ``hostec`` -> ``p256``): pure Python ints, no
third-party imports, some 50-100x the affine oracle (`common/p256`).

Design (the shape of the device kernel, tuned for CPython):

- **Lane-vectorized field ops.** A batch is a list of Python ints per
  coordinate; every field operation is one fused list comprehension over
  all lanes (one interpreter pass, one ``%`` per lane per op). All lanes
  advance through the *same* window schedule, so the work is array-shaped
  — there is no per-signature control flow in the hot loop.
- **Jacobian coordinates** (no inversions in the group law): doubling is
  dbl-2001-b for a = -3 (8 big mults), mixed add is the standard
  Jacobian+affine madd (11 big mults). Exceptional lanes (P = +-Q,
  P = infinity) are detected wholesale via ``0 in Z3`` and patched with a
  scalar fallback — they are adversarially reachable, never hot.
- **Shamir's trick, joint Horner loop**: u1*G + u2*Q shares one doubling
  chain. Q uses 4-bit windows (a per-lane 15-entry table, normalized to
  affine with ONE Montgomery batch inversion across table x lanes); G
  rides the same doublings with 8-bit windows into a precomputed global
  255-entry affine table, so the fixed base costs 32 adds, not 256
  doublings.
- **Montgomery batch inversion** everywhere an inverse is needed per lane
  (s^-1 mod n, table normalization, the final affine x comparison):
  3 mults per element plus a single Fermat ``pow`` per batch instead of
  one ~170us ``pow`` per lane.
- **Process-pool sharding**: batches >= ``MIN_POOL_LANES`` lanes split
  evenly across CPU cores (``FABRIC_TPU_HOSTEC_PROCS``, default all).
  Shards are concatenated in submission order, so results are
  order-preserving. The pool is created lazily and shared process-wide;
  ``parallel.batcher.VerifyBatcher`` rides it through the software
  provider's ``batch_verify_async`` seam.

Semantics are bit-identical to the oracle (tests/test_torch_hostec.py
holds the mask to the JAX tier's and the oracle's): ``verify_digest`` implements Go
crypto/ecdsa.Verify — no low-S rule here (callers pre-check via
``bccsp.parse_and_precheck``), out-of-range r/s and off-curve or identity
public keys return False and never raise. ``sign_digest`` normalizes to
low-S exactly like the p256 oracle.
"""

from __future__ import annotations

import os
import secrets
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.retry import CooldownGate
from fabric_tpu_torch.common import p256
from fabric_tpu_torch.common.p256 import A, B, GX, GY, HALF_N, N, P, hash_to_int

logger = must_get_logger("hostec")



class KeyPair(NamedTuple):
    priv: int
    pub: Tuple[int, int]


# Public keys as affine (x, y) tuples; None marks an unusable lane (the
# identity / a parse failure) which verifies False.
PubKey = Optional[Tuple[int, int]]

WINDOW_BITS = 4
NUM_WINDOWS = 64  # 256 / 4
G_WINDOW_BITS = 8  # fixed-base digits ride every 2nd doubling round

# Below this lane count a pool round-trip costs more than it saves.
MIN_POOL_LANES = 256


# ---------------------------------------------------------------------------
# Scalar Jacobian helpers (table precompute + exceptional-lane patches)
# ---------------------------------------------------------------------------


def _dbl1(X: int, Y: int, Z: int) -> Tuple[int, int, int]:
    """dbl-2001-b (a = -3). Complete for this curve: Z=0 stays Z=0 and
    P-256 has no 2-torsion, so Y=0 never occurs on-curve."""
    delta = Z * Z % P
    gamma = Y * Y % P
    beta = X * gamma % P
    alpha = 3 * (X - delta) * (X + delta) % P
    X3 = (alpha * alpha - 8 * beta) % P
    Z3 = ((Y + Z) * (Y + Z) - gamma - delta) % P
    Y3 = (alpha * (4 * beta - X3) - 8 * gamma * gamma) % P
    return X3, Y3, Z3


def _madd1(X: int, Y: int, Z: int, x2: int, y2: int) -> Tuple[int, int, int]:
    """Mixed Jacobian + affine add with the exceptional cases handled."""
    if Z == 0:
        return x2, y2, 1
    ZZ = Z * Z % P
    U2 = x2 * ZZ % P
    S2 = y2 * Z * ZZ % P
    H = (U2 - X) % P
    R = (S2 - Y) % P
    if H == 0:
        if R == 0:
            return _dbl1(x2, y2, 1)  # P == Q
        return 1, 1, 0  # P == -Q
    HH = H * H % P
    HHH = H * HH % P
    V = X * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    Y3 = (R * (V - X3) - Y * HHH) % P
    Z3 = Z * H % P
    return X3, Y3, Z3


# ---------------------------------------------------------------------------
# Lane-vectorized group law (lists of ints; fused list comprehensions)
# ---------------------------------------------------------------------------

Lanes = List[int]


def _dbl_vec(X: Lanes, Y: Lanes, Z: Lanes) -> Tuple[Lanes, Lanes, Lanes]:
    delta = [z * z % P for z in Z]
    gamma = [y * y % P for y in Y]
    beta = [x * g % P for x, g in zip(X, gamma)]
    alpha = [3 * (x - d) * (x + d) % P for x, d in zip(X, delta)]
    X3 = [(a * a - 8 * b) % P for a, b in zip(alpha, beta)]
    Z3 = [
        ((y + z) * (y + z) - g - d) % P
        for y, z, g, d in zip(Y, Z, gamma, delta)
    ]
    Y3 = [
        (a * (4 * b - x3) - 8 * g * g) % P
        for a, b, x3, g in zip(alpha, beta, X3, gamma)
    ]
    return X3, Y3, Z3


def _madd_vec(
    X: Lanes, Y: Lanes, Z: Lanes, x2: Lanes, y2: Lanes
) -> Tuple[Lanes, Lanes, Lanes]:
    """Vector mixed add. Z3 = Z*H is 0 exactly on the exceptional lanes
    (P = infinity, P = +-Q), which are then recomputed scalar-wise — the
    check itself is one C-level ``in`` scan per add."""
    ZZ = [z * z % P for z in Z]
    U2 = [a * b % P for a, b in zip(x2, ZZ)]
    S2 = [y * z * zz % P for y, z, zz in zip(y2, Z, ZZ)]
    H = [(u - x) % P for u, x in zip(U2, X)]
    R = [(s - y) % P for s, y in zip(S2, Y)]
    HH = [h * h % P for h in H]
    HHH = [h * hh % P for h, hh in zip(H, HH)]
    V = [x * hh % P for x, hh in zip(X, HH)]
    X3 = [(r * r - hhh - 2 * v) % P for r, hhh, v in zip(R, HHH, V)]
    Y3 = [
        (r * (v - x3) - y * hhh) % P
        for r, v, x3, y, hhh in zip(R, V, X3, Y, HHH)
    ]
    Z3 = [z * h % P for z, h in zip(Z, H)]
    if 0 in Z3:
        for i, z3 in enumerate(Z3):
            if z3 == 0:
                X3[i], Y3[i], Z3[i] = _madd1(X[i], Y[i], Z[i], x2[i], y2[i])
    return X3, Y3, Z3


def _batch_inv(vals: Sequence[int], m: int) -> List[int]:
    """Montgomery batch inversion mod a prime m: 3 mults per element plus
    ONE Fermat pow for the whole batch. Zero entries yield 0 (callers mask
    those lanes) without poisoning the product chain."""
    n = len(vals)
    pre = [1] * (n + 1)
    acc = 1
    for i, v in enumerate(vals):
        if v:
            acc = acc * v % m
        pre[i + 1] = acc
    inv_acc = pow(acc, m - 2, m)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v:
            out[i] = inv_acc * pre[i] % m
            inv_acc = inv_acc * v % m
    return out


# ---------------------------------------------------------------------------
# Precomputed fixed-base tables (lazy; module-level caches)
# ---------------------------------------------------------------------------

_G_HORNER: Optional[Tuple[List[int], List[int]]] = None  # d*G, d in 1..255
_G_COMB: Optional[List[List[Tuple[int, int]]]] = None  # [w][d-1] = d*16^w*G
# lazy-build guard: the verify path runs on the batcher's dispatch
# thread, the commit thread, AND inline fallbacks concurrently — an
# unlocked first build is merely idempotent-but-wasted work (hundreds of
# field inversions per extra builder)
_TABLE_LOCK = threading.Lock()


def _normalize_jacobians(
    pts: Sequence[Tuple[int, int, int]],
) -> List[Tuple[int, int]]:
    zinv = _batch_inv([p[2] for p in pts], P)
    out = []
    for (X, Y, _Z), zi in zip(pts, zinv):
        zi2 = zi * zi % P
        out.append((X * zi2 % P, Y * zi2 * zi % P))
    return out


def _g_horner_table() -> Tuple[List[int], List[int]]:
    """Affine d*G for d in 1..255 (index d-1), one batch inversion total."""
    global _G_HORNER
    if _G_HORNER is None:
        with _TABLE_LOCK:
            if _G_HORNER is None:
                jac = [(GX, GY, 1)]
                for _ in range(254):
                    X, Y, Z = jac[-1]
                    jac.append(_madd1(X, Y, Z, GX, GY))
                aff = _normalize_jacobians(jac)
                _G_HORNER = ([x for x, _ in aff], [y for _, y in aff])
    return _G_HORNER


def _g_comb_table() -> List[List[Tuple[int, int]]]:
    """Affine d * 16^w * G for w in 0..63, d in 1..15 — the fixed-base comb
    for signing/keygen: a base mult is 64 mixed adds, zero doublings."""
    global _G_COMB
    if _G_COMB is None:
        with _TABLE_LOCK:
            if _G_COMB is None:
                rows_jac: List[List[Tuple[int, int, int]]] = []
                base = (GX, GY, 1)
                for _w in range(NUM_WINDOWS):
                    bz = pow(base[2], P - 2, P)
                    bz2 = bz * bz % P
                    bx, by = base[0] * bz2 % P, base[1] * bz2 * bz % P
                    row = [(bx, by, 1)]
                    for _d in range(14):
                        X, Y, Z = row[-1]
                        row.append(_madd1(X, Y, Z, bx, by))
                    rows_jac.append(row)
                    base = (bx, by, 1)
                    for _ in range(WINDOW_BITS):
                        base = _dbl1(*base)
                flat = _normalize_jacobians(
                    [p for row in rows_jac for p in row]
                )
                _G_COMB = [
                    flat[w * 15 : (w + 1) * 15] for w in range(NUM_WINDOWS)
                ]
    return _G_COMB


def warm_tables() -> None:
    """Build both fixed-base tables now (e.g. before forking pool workers)."""
    _g_horner_table()
    _g_comb_table()


# ---------------------------------------------------------------------------
# Core batch verification
# ---------------------------------------------------------------------------


def _precheck_lanes(lanes):
    """Per-lane prechecks mirroring the oracle exactly: r/s range, key
    present, coordinates in range, curve equation.  Bad lanes get
    benign substitutes (r = s = 1, Q = G, e = 0) so vector math stays
    defined, and must be forced False at the end.  Shared by this
    engine and crypto/hostec_np — the tiers' accept/reject sets are a
    load-bearing bit-exactness contract, so there is exactly ONE copy
    of it."""
    nlanes = len(lanes)
    valid = [True] * nlanes
    rr = [1] * nlanes
    ss = [1] * nlanes
    qx = [GX] * nlanes
    qy = [GY] * nlanes
    ee = [0] * nlanes
    for i, (pub, digest, r, s) in enumerate(lanes):
        if not (1 <= r < N and 1 <= s < N) or pub is None:
            valid[i] = False
            continue
        x, y = pub
        if not (0 <= x < P and 0 <= y < P) or (
            y * y - (x * x * x + A * x + B)
        ) % P != 0:
            valid[i] = False
            continue
        rr[i], ss[i] = r, s
        qx[i], qy[i] = x, y
        ee[i] = hash_to_int(digest)
    return valid, rr, ss, qx, qy, ee


def verify_parsed_batch(
    lanes: Sequence[Tuple[PubKey, bytes, int, int]],
) -> List[bool]:
    """One vectorized pass over (pub, digest, r, s) lanes, all in THIS
    process. Bit-exact with ``p256.verify_digest`` per lane; the low-S rule
    is NOT applied here (same contract as the oracle)."""
    nlanes = len(lanes)
    if nlanes == 0:
        return []

    valid, rr, ss, qx, qy, ee = _precheck_lanes(lanes)

    # u1 = e/s, u2 = r/s mod n — one batch inversion for every lane's s.
    w = _batch_inv(ss, N)
    u1 = [e * wi % N for e, wi in zip(ee, w)]
    u2 = [r * wi % N for r, wi in zip(rr, w)]

    # Per-lane 4-bit window table d*Q, d in 1..15 (index d-1), built
    # vectorized then normalized to affine with one batch inversion so the
    # hot loop uses 11-mult mixed adds. d*Q is never the identity for
    # d <= 15 (prime group order), so no exceptional lanes here.
    ones = [1] * nlanes
    tab_jac = [(qx, qy, ones)]
    d2x, d2y, d2z = _dbl_vec(qx, qy, ones)
    tab_jac.append((d2x, d2y, d2z))
    for _d in range(3, 16):
        X, Y, Z = tab_jac[-1]
        tab_jac.append(_madd_vec(X, Y, Z, qx, qy))
    flat_z = [z for _X, _Y, Z in tab_jac for z in Z]
    zinv = _batch_inv(flat_z, P)
    tqx: List[Lanes] = []
    tqy: List[Lanes] = []
    for t, (X, Y, _Z) in enumerate(tab_jac):
        zi = zinv[t * nlanes : (t + 1) * nlanes]
        zi2 = [a * a % P for a in zi]
        tqx.append([x * a % P for x, a in zip(X, zi2)])
        tqy.append([y * a * b % P for y, a, b in zip(Y, zi2, zi)])

    gx_tab, gy_tab = _g_horner_table()

    # Joint Horner: R = 16*R + d2_k*Q every round (k = 63-j), plus
    # d1_i*G every odd round (i = (63-j)/2, 8-bit digits). Every lane
    # walks this same schedule; digit-0 lanes compute the add too and a
    # select keeps their old point.
    RX, RY, RZ = [1] * nlanes, [1] * nlanes, [0] * nlanes
    for j in range(NUM_WINDOWS):
        if j:
            for _ in range(WINDOW_BITS):
                RX, RY, RZ = _dbl_vec(RX, RY, RZ)
        sh = 4 * (NUM_WINDOWS - 1 - j)
        ds = [(u >> sh) & 15 for u in u2]
        ax = [tqx[d - 1][i] if d else GX for i, d in enumerate(ds)]
        ay = [tqy[d - 1][i] if d else GY for i, d in enumerate(ds)]
        NX, NY, NZ = _madd_vec(RX, RY, RZ, ax, ay)
        RX = [n if d else o for n, o, d in zip(NX, RX, ds)]
        RY = [n if d else o for n, o, d in zip(NY, RY, ds)]
        RZ = [n if d else o for n, o, d in zip(NZ, RZ, ds)]
        if j & 1:
            gsh = 8 * ((NUM_WINDOWS - 1 - j) >> 1)
            ds = [(u >> gsh) & 255 for u in u1]
            ax = [gx_tab[d - 1] if d else GX for d in ds]
            ay = [gy_tab[d - 1] if d else GY for d in ds]
            NX, NY, NZ = _madd_vec(RX, RY, RZ, ax, ay)
            RX = [n if d else o for n, o, d in zip(NX, RX, ds)]
            RY = [n if d else o for n, o, d in zip(NY, RY, ds)]
            RZ = [n if d else o for n, o, d in zip(NZ, RZ, ds)]

    # Affine comparison x(R) mod n == r via one final batch inversion.
    zinv = _batch_inv(RZ, P)
    out = []
    for i in range(nlanes):
        if not valid[i] or RZ[i] == 0:
            out.append(False)
            continue
        zi = zinv[i]
        x_aff = RX[i] * zi * zi % P
        out.append(x_aff % N == rr[i])
    return out


# ---------------------------------------------------------------------------
# Process-pool sharding
# ---------------------------------------------------------------------------

_POOL = None
_POOL_PROCS = 1
_POOL_LOCK = threading.Lock()
# a pool that just broke must not be rebuilt in a hot loop: each
# breakage opens an exponentially longer cooldown during which big
# batches stay inline (mutated only under _POOL_LOCK)
_POOL_GATE = CooldownGate()


def pool_procs() -> int:
    """Worker count the pool will use (1 = pool disabled).  A malformed
    FABRIC_TPU_HOSTEC_PROCS must degrade to the default, never raise out
    of the verify path.  The default clamps at 8: spawn-method workers
    re-import the parent's __main__ script, so an uncapped cpu_count on a
    big host would turn the first large batch into a multi-second
    worker-boot stall."""
    procs = os.environ.get("FABRIC_TPU_HOSTEC_PROCS", "")
    if procs:
        try:
            return max(int(procs), 1)
        except ValueError:
            pass
    return min(os.cpu_count() or 1, 8)


def start_method() -> str:
    """The host pools' start method (hostec, hostec_np, hostbn):
    forkserver, else spawn, never fork.  A forked child of a process that
    holds a CUDA context inherits a context it cannot use, and the parent
    is multithreaded by then (the batcher's dispatcher, the commit
    thread), so a fork can also wedge a worker on a lock another thread
    held.  Forkserver and spawn workers start from a fresh interpreter
    and import only the tier's module."""
    import multiprocessing

    methods = multiprocessing.get_all_start_methods()
    return "forkserver" if "forkserver" in methods else "spawn"


def _pool():
    """Lazy shared ProcessPoolExecutor, started by `start_method()`; each
    worker builds the fixed-base tables (a few ms, once).  Workers also
    re-import the parent's __main__ script — hence the pool_procs()
    clamp."""
    global _POOL, _POOL_PROCS
    with _POOL_LOCK:
        if _POOL is None:
            if not _POOL_GATE.ready():
                # recently broken: stay inline for the cooldown instead
                # of paying a worker-boot stall per batch in a hot loop
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
                    mp_context=multiprocessing.get_context(start_method()),
                )
                fabobs.obs_count("fabric_pool_rebuilds_total", pool="hostec")
            except Exception as exc:  # pragma: no cover - restricted environments
                logger.warning(
                    "process pool unavailable (%s); verifying inline", exc
                )
                _POOL = False
    return _POOL or None


def shutdown_pool(broken: bool = False) -> None:
    """Tear the pool down.  ``broken=True`` (the degrade paths) also
    arms the rebuild cooldown so a flapping pool can't thrash; a clean
    shutdown (tests, a smoke's teardown) leaves the gate closed."""
    global _POOL
    with _POOL_LOCK:
        if _POOL:
            _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None
        if broken:
            _POOL_GATE.record_failure()
    if broken:
        fabobs.obs_count("fabric_pool_cooldowns_total", pool="hostec")
        fabobs.obs_count("fabric_degrade_total", seam="hostec.pool")
        fabobs.obs_trigger("hostec.pool_broken")


def verify_parsed_batch_sharded(
    lanes: Sequence[Tuple[PubKey, bytes, int, int]],
) -> Callable[[], List[bool]]:
    """Shard a parsed batch across the process pool; returns a resolver
    (call it for the verdicts) so callers — the VerifyBatcher dispatcher
    in particular — can overlap host prep with shard execution. Shards
    are reassembled in submission order: results are order-preserving.

    Small batches (or a disabled/unavailable pool) run inline.  A pool
    that breaks (worker OOM-killed, interpreter torn down) is discarded
    and the batch recomputed inline — degrade, never die: the next big
    batch lazily builds a fresh pool."""
    lanes = list(lanes)
    pool = _pool() if len(lanes) >= MIN_POOL_LANES else None
    if pool is None:
        out = verify_parsed_batch(lanes)
        return lambda: out
    nshards = min(_POOL_PROCS, max(len(lanes) // (MIN_POOL_LANES // 2), 1))
    step = (len(lanes) + nshards - 1) // nshards
    try:
        fault_point("hostec.pool.submit")
        futures = [
            pool.submit(verify_parsed_batch, lanes[off : off + step])
            for off in range(0, len(lanes), step)
        ]
    except Exception as exc:  # BrokenProcessPool / shutdown race
        logger.warning("pool submit failed (%s); recomputing inline", exc)
        shutdown_pool(broken=True)
        out = verify_parsed_batch(lanes)
        return lambda: out

    def resolve() -> List[bool]:
        out: List[bool] = []
        try:
            fault_point("hostec.pool.resolve")
            for f in futures:
                out.extend(f.result())
        except Exception as exc:  # worker died mid-run: inline fallback
            logger.warning(
                "pool worker died mid-batch (%s); recomputing inline", exc
            )
            shutdown_pool(broken=True)
            return verify_parsed_batch(lanes)
        # only a batch that made it THROUGH the pool resets the rebuild
        # cooldown ramp — construction succeeding proves nothing about a
        # persistently worker-killing environment
        with _POOL_LOCK:
            _POOL_GATE.record_success()
        return out

    return resolve


# ---------------------------------------------------------------------------
# Scalar API — drop-in parity with crypto.p256
# ---------------------------------------------------------------------------


def verify_digest(pub: Tuple[int, int], digest: bytes, r: int, s: int) -> bool:
    """Go crypto/ecdsa.Verify semantics (no low-S rule), single lane."""
    return verify_parsed_batch([(pub, digest, r, s)])[0]


def scalar_base_mult(k: int) -> p256.AffinePoint:
    """k*G via the fixed-base comb: 64 mixed adds, zero doublings."""
    k %= N
    if k == 0:
        return None
    comb = _g_comb_table()
    X, Y, Z = 1, 1, 0
    for w in range(NUM_WINDOWS):
        d = (k >> (4 * w)) & 15
        if d:
            X, Y, Z = _madd1(X, Y, Z, *comb[w][d - 1])
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def sign_digest(priv: int, digest: bytes) -> Tuple[int, int]:
    """ECDSA sign, low-S normalized (reference signECDSA -> ToLowS)."""
    e = hash_to_int(digest)
    while True:
        k = secrets.randbelow(N - 1) + 1
        pt = scalar_base_mult(k)
        if pt is None:
            raise ArithmeticError("k*G is infinity for k in [1, N-1]")
        r = pt[0] % N
        if r == 0:
            continue
        s = pow(k, N - 2, N) * (e + r * priv) % N
        if s == 0:
            continue
        if s > HALF_N:
            s = N - s
        return r, s


def generate_keypair() -> KeyPair:
    d = secrets.randbelow(N - 1) + 1
    q = scalar_base_mult(d)
    if q is None:
        raise ArithmeticError("d*G is infinity for d in [1, N-1]")
    return KeyPair(d, q)
