"""Deterministic fault injection.

A copy of the JAX package's `common/faults`: the same plan grammar, the same
environment variables, and the same keyed decision (``sha256(seed|site|key)``
against the probability), so one plan fires the same faults at the same
(site, key) in both packages. The port carries these fault points:

=================================  ==========================================
site                               seam
=================================  ==========================================
``batcher.submit``                 VerifyBatcher.submit, before lane admission
``batcher.dispatch``               VerifyBatcher dispatcher, per launch attempt
``pipeline.commit``                CommitPipeline._commit_loop, before
                                   store_block
``bccsp.dispatch``                 SoftwareProvider batch dispatch (EC ladder)
``bccsp.verdict``                  SoftwareProvider verdict mask (corrupt
                                   action)
``hostec.pool.submit``             hostec shard submission to the process pool
``hostec.pool.resolve``            hostec shard result join
``hostec_np.pool.submit``          hostec_np shm shard submission
``hostec_np.pool.resolve``         hostec_np shm shard result join
``hostbn.pool.submit``             hostbn idemix shard submission
``hostbn.pool.resolve``            hostbn idemix shard result join
``idemix.verdict``                 idemix/batch verdict mask (corrupt action)
``serve.dispatch``                 SidecarServer, one verify request before
                                   admission (keyed by the server's
                                   ``chaos_key`` when it has one)
``serve.route``                    SidecarRouter, one dispatch attempt at one
                                   endpoint (keyed (address, attempt))
``blockstore.append.pre_fsync``    BlockStore.add_block, frame written but not
                                   yet fsynced (kill window)
``blockstore.append.post_fsync``   BlockStore.add_block, frame fsynced,
                                   directory entry not yet (kill window)
``blockstore.append.pre_index``    BlockStore.add_block, durable on disk,
                                   in-memory index not updated (kill window)
``kvledger.commit.pre_pvt``        KVLedger.commit, before the pvt store write
                                   (kill window)
``kvledger.commit.post_block``     KVLedger.commit, block appended, state not
                                   yet committed (kill window)
``persistent.commit.mid``          SqliteVersionedDB.commit_block, mid
                                   transaction before the savepoint row
                                   (kill window)
=================================  ==========================================

A ``fault_point(site, key=...)`` call costs ONE module-global load and a
``None`` check when no plan is installed — the registry is free in
production.  With a plan installed it either does nothing, raises
:class:`InjectedFault`, sleeps (``delay``), or returns the matched
:class:`FaultSpec` for actions the site must interpret itself
(``corrupt`` / ``drop``).

Determinism: every decision is a pure function of ``(plan seed, site,
key)`` — ``sha256(seed|site|key)`` compared against the probability — so
a replayed seed injects the *same* faults regardless of thread
interleaving, as long as call sites pass stable keys.  Sites that pass
no key fall back to a per-site seeded counter (order-dependent across
threads; documented per site).  ``max_fires`` caps are counter-based and
therefore order-dependent by nature.

Plan grammar (``FABRIC_TPU_FAULTS`` env var or :meth:`FaultPlan.parse`)::

    plan   := entry (";" entry)*
    entry  := site "=" action [":" prob] (":" param "=" int)*
    action := "raise" | "delay" | "corrupt" | "drop" | "kill"
    params := max (max fires) | ms (delay millis) | lanes (corrupt width)
              | at (fire only when the call key equals this int)

    FABRIC_TPU_FAULTS="batcher.dispatch=raise:0.2:max=3;pipeline.commit=raise:0.5"
    FABRIC_TPU_FAULTS_SEED=7

The ``kill`` action is the crash-consistency harness: the
process dies on the spot via ``os._exit(137)`` — no atexit hooks, no
interpreter cleanup, no flushing of Python-buffered file data — the
deterministic stand-in for SIGKILLing a peer mid-commit.  The ``at``
param pins a kill (or any action) to one exact call key (a block
number), which is how a crash test walks kill WINDOWS instead of
kill probabilities.  ``FABRIC_TPU_CRASH_SITES`` is operator sugar for
kill plans: ``site[@block]`` entries joined by ``;``/``,`` that merge
into the installed plan alongside ``FABRIC_TPU_FAULTS``.

A malformed env plan warns and installs nothing — chaos knobs must never
poison a production import.
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from fabric_tpu_torch.common import fabobs

ACTIONS = ("raise", "delay", "corrupt", "drop", "kill")

#: the kill action's exit code: what a SIGKILLed process reports (128+9),
#: so harnesses watching returncodes treat os._exit kills and real
#: SIGKILLs identically
KILL_EXIT_CODE = 137


class InjectedFault(Exception):
    """Raised by a fault point running a ``raise`` action.  Transient by
    contract: retry layers (common.retry) may retry it, mask layers must
    fail closed on it like any other exception."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site}")
        self.site = site


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault: ``site=action:prob:param=...``."""

    site: str
    action: str  # raise | delay | corrupt | drop | kill
    prob: float = 1.0
    max_fires: int = 0  # 0 = unlimited
    delay_ms: int = 10  # delay action: sleep duration
    lanes: int = 1  # corrupt action: verdict lanes to flip
    at_key: Optional[int] = None  # fire only when the call key == at_key

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} "
                f"(expected one of {ACTIONS})"
            )
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"fault probability {self.prob!r} not in [0, 1]")


def _keyed_hit(seed: int, site: str, key, prob: float) -> bool:
    """Pure decision function: identical (seed, site, key) -> identical
    verdict, independent of call order and thread scheduling."""
    if prob >= 1.0:
        return True
    h = hashlib.sha256(
        f"{seed}|{site}|{key!r}".encode("utf-8", "backslashreplace")
    ).digest()
    return int.from_bytes(h[:8], "big") < prob * 2.0**64


class FaultPlan:
    """A set of armed fault specs plus per-site fire accounting."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for spec in specs:
            self._by_site.setdefault(spec.site, []).append(spec)
        self._lock = threading.Lock()
        # per-SPEC fire counters (a site may carry several specs, each
        # with its own max_fires budget); fired() aggregates per site
        self._fired: Dict[int, int] = {}
        # unkeyed decisions draw from a per-site seeded stream
        self._rng: Dict[str, random.Random] = {}
        self._warned: set = set()  # (site, action) mismatch warnings

    # -- construction ----------------------------------------------------
    @classmethod
    def parse(
        cls, text: str, seed: int = 0
    ) -> "FaultPlan":
        """Parse the ``site=action:prob:param=v`` grammar; raises
        ValueError on malformed entries (env installation catches)."""
        specs: List[FaultSpec] = []
        for raw in text.replace(",", ";").split(";"):
            entry = raw.strip()
            if not entry:
                continue
            site, sep, rhs = entry.partition("=")
            if not sep or not site.strip():
                raise ValueError(f"fault entry {entry!r} is not site=action")
            parts = rhs.split(":")
            action = parts[0].strip()
            kwargs = {"site": site.strip(), "action": action}
            pos = 1
            if len(parts) > 1 and "=" not in parts[1]:
                kwargs["prob"] = float(parts[1])
                pos = 2
            for param in parts[pos:]:
                name, psep, value = param.partition("=")
                if not psep:
                    raise ValueError(
                        f"fault param {param!r} is not name=int"
                    )
                name = name.strip()
                if name == "max":
                    kwargs["max_fires"] = int(value)
                elif name == "ms":
                    kwargs["delay_ms"] = int(value)
                elif name == "lanes":
                    kwargs["lanes"] = int(value)
                elif name == "at":
                    kwargs["at_key"] = int(value)
                else:
                    raise ValueError(f"unknown fault param {name!r}")
            specs.append(FaultSpec(**kwargs))
        return cls(specs, seed=seed)

    @classmethod
    def from_dict(
        cls, mapping: Dict[str, Union[str, FaultSpec]], seed: int = 0
    ) -> "FaultPlan":
        """{"site": "action:prob:param=v" | FaultSpec} convenience."""
        specs: List[FaultSpec] = []
        for site, rhs in mapping.items():
            if isinstance(rhs, FaultSpec):
                specs.append(rhs)
            else:
                plan = cls.parse(f"{site}={rhs}")
                specs.extend(plan.specs())
        return cls(specs, seed=seed)

    def specs(self) -> List[FaultSpec]:
        return [s for lst in self._by_site.values() for s in lst]

    # -- decision --------------------------------------------------------
    def check(
        self, site: str, key=None, interprets: Sequence[str] = ()
    ) -> Optional[FaultSpec]:
        """The armed spec that fires for this call, or None.  Counts
        fires and honors per-spec ``max_fires`` caps.  ``interprets``
        names the corrupt/drop actions this site actually implements:
        a spec whose action the site would silently discard is skipped
        WITHOUT counting as fired (and warns once) — an operator must
        never read 'pipeline.commit=drop fired N times' off a scorecard
        when nothing was injected."""
        specs = self._by_site.get(site)
        if not specs:
            return None
        for spec in specs:
            if spec.action in ("corrupt", "drop") and (
                spec.action not in interprets
            ):
                self._warn_uninterpreted(site, spec.action)
                continue
            if spec.at_key is not None and key != spec.at_key:
                # window-pinned spec (crash-test kill points): only the
                # exact call key arms it; other calls pass untouched
                continue
            if spec.prob < 1.0 and key is None:
                with self._lock:
                    rng = self._rng.get(site)
                    if rng is None:
                        rng = self._rng[site] = random.Random(
                            (self.seed << 32)
                            ^ int.from_bytes(
                                hashlib.sha256(site.encode()).digest()[:4],
                                "big",
                            )
                        )
                    hit = rng.random() < spec.prob
            else:
                hit = _keyed_hit(self.seed, site, key, spec.prob)
            if not hit:
                continue
            with self._lock:
                fired = self._fired.get(id(spec), 0)
                if spec.max_fires and fired >= spec.max_fires:
                    continue
                self._fired[id(spec)] = fired + 1
            return spec
        return None

    def _warn_uninterpreted(self, site: str, action: str) -> None:
        with self._lock:
            if (site, action) in self._warned:
                return
            self._warned.add((site, action))
        import warnings

        warnings.warn(
            f"fault plan arms {site}={action}, but that site does not "
            f"interpret {action!r} — the spec is ignored (not counted)",
            RuntimeWarning,
            stacklevel=4,
        )

    def fired(self) -> Dict[str, int]:
        """Snapshot of per-site fire counts (scorecard material)."""
        with self._lock:
            out: Dict[str, int] = {}
            for site, specs in self._by_site.items():
                n = sum(self._fired.get(id(s), 0) for s in specs)
                if n:
                    out[site] = n
            return out

    def reset_counters(self) -> None:
        with self._lock:
            self._fired.clear()
            self._rng.clear()


# ---------------------------------------------------------------------------
# Process-wide installation.  _PLAN is written only under _PLAN_LOCK
# (install/uninstall are control-plane rare); the hot-path read in
# fault_point is a single GIL-atomic global load.
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()


def install_plan(plan: Optional[FaultPlan]) -> None:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = plan


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


class plan_installed:
    """``with plan_installed(plan):`` — scoped installation (tests and
    scenario runners).  The PREVIOUS plan is restored on
    exit, so a scenario run inside a process chaos'd via
    FABRIC_TPU_FAULTS does not silently disarm the operator's plan.
    Not reentrant across threads: one plan is process-wide by design
    (the seams read one global)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self._prev = active_plan()
        install_plan(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        install_plan(self._prev)


def faults_enabled() -> bool:
    return _PLAN is not None


def fault_point(
    site: str, key=None, interprets: Sequence[str] = ()
) -> Optional[FaultSpec]:
    """The injection seam.  No plan installed: returns None at the cost
    of one global load.  Otherwise: ``raise`` raises InjectedFault,
    ``delay`` sleeps then returns None (transparent), ``corrupt`` and
    ``drop`` return the spec for the call site to interpret —
    ``interprets`` declares which of those the site implements (an
    unsupported action is skipped, uncounted, with a one-shot warning).

    Key discipline: pass a key only when it genuinely varies per
    decision (block number, connection attempt, stream sequence) —
    replayed seeds then inject identical faults independent of thread
    order.  Sites whose natural key is static per steady-state call
    (a fixed batch size) must pass key=None: the per-site seeded
    stream keeps probabilistic plans probabilistic instead of
    degenerating into all-or-nothing per key value."""
    plan = _PLAN
    if plan is None:
        return None
    spec = plan.check(site, key, interprets)
    if spec is None:
        return None
    # chaos runs become observable: every fired injection is a counter
    # series (and an obs event) when the registry is enabled — metrics
    # are memory-only, so the deterministic scorecard stays byte-exact
    fabobs.obs_count("fabric_fault_fired_total", site=site)
    fabobs.obs_event("fault.fired", site=site, action=spec.action)
    if spec.action == "raise":
        raise InjectedFault(site)
    if spec.action == "delay":
        time.sleep(spec.delay_ms / 1000.0)
        return None
    if spec.action == "kill":
        # SIGKILL stand-in: die NOW, from any thread, with no interpreter
        # cleanup — atexit hooks don't run and Python-buffered file data
        # is lost, exactly the torn-write surface a real kill exposes.
        # Whatever the seam already pushed to the OS survives (the OS
        # flushes its own page cache); whatever sits in Python buffers
        # does not.
        os._exit(KILL_EXIT_CODE)
    return spec


def corrupt_verdicts(verdicts: Sequence[bool], spec: FaultSpec) -> List[bool]:
    """Flip the first ``spec.lanes`` verdicts (all lanes when 0) — the
    ``corrupt`` action's standard interpretation at mask-producing
    sites.  Exists so a bit-exact mask assertion can be shown to CATCH a
    verdict-corrupting bug; never reachable without an installed plan."""
    out = list(verdicts)
    n = len(out) if spec.lanes <= 0 else min(spec.lanes, len(out))
    for i in range(n):
        out[i] = not out[i]
    return out


def crash_specs_from_text(text: str) -> List[FaultSpec]:
    """Parse the FABRIC_TPU_CRASH_SITES kill-point selector: ``site`` or
    ``site@block`` entries joined by ``;``/``,`` — sugar for
    ``site=kill:max=1`` / ``site=kill:at=block:max=1``.  A crash test
    arms its child processes this way; raises ValueError on malformed
    entries."""
    specs: List[FaultSpec] = []
    for raw in text.replace(",", ";").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        site, _sep, at = entry.partition("@")
        site = site.strip()
        if not site:
            raise ValueError(f"crash site entry {entry!r} has no site")
        specs.append(
            FaultSpec(
                site=site,
                action="kill",
                max_fires=1,
                at_key=int(at) if at.strip() else None,
            )
        )
    return specs


def _install_from_env() -> None:
    """Honor FABRIC_TPU_FAULTS (+ the FABRIC_TPU_CRASH_SITES kill-point
    sugar) at import so external runs (a node under soak, the child
    processes of a crash test) can be chaos'd without code
    changes.  Malformed values warn and install nothing — never raise
    out of an import."""
    text = os.environ.get("FABRIC_TPU_FAULTS", "")
    crash_text = os.environ.get("FABRIC_TPU_CRASH_SITES", "")
    if not text and not crash_text:
        return
    seed_raw = os.environ.get("FABRIC_TPU_FAULTS_SEED", "0")
    try:
        seed = int(seed_raw)
    except ValueError:
        seed = 0
    import warnings

    specs: List[FaultSpec] = []
    try:
        if text:
            specs.extend(FaultPlan.parse(text, seed=seed).specs())
    except (ValueError, TypeError) as exc:
        warnings.warn(
            f"FABRIC_TPU_FAULTS ignored (malformed: {exc})",
            RuntimeWarning,
            stacklevel=2,
        )
    try:
        if crash_text:
            specs.extend(crash_specs_from_text(crash_text))
    except (ValueError, TypeError) as exc:
        warnings.warn(
            f"FABRIC_TPU_CRASH_SITES ignored (malformed: {exc})",
            RuntimeWarning,
            stacklevel=2,
        )
    if specs:
        install_plan(FaultPlan(specs, seed=seed))


_install_from_env()
