"""Process profiling for the operations server — the Python analog of
the reference's Go pprof service (orderer/common/server/main.go:458,
peer `node start` profile listener).

Go pprof's value is (a) sampled CPU profiles and (b) goroutine dumps.
The analogs here:

- cpu_profile(seconds): statistical sampler over sys._current_frames()
  across ALL threads, reported as collapsed stacks ("frame;frame;... N")
  — the flamegraph input format, aggregated by identical stack.
- thread_dump(): every live thread's current stack (goroutine profile).
- heap_profile(): tracemalloc top allocation sites.

The port's counterpart of the JAX package's `operations/pprof.py`. A
departure in `heap_profile`: the JAX one starts tracing on its first call,
answers a note and leaves tracing on for the rest of the process, which
makes every later allocation of the process many times slower. The port's
takes its snapshot in the same call: with tracing off it traces for
`seconds`, takes the snapshot and stops the tracing it started; tracing that
was on before the call stays on, and the snapshot is taken at once. The
profile's text is the JAX one's for the same snapshot (`render_snapshot`).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter


def thread_dump() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(frames.items()):
        out.append(f"thread {ident} [{names.get(ident, '?')}]:")
        out.extend(
            line.rstrip()
            for line in traceback.format_stack(frame)
        )
        out.append("")
    return "\n".join(out)


def _collapse(frame) -> str:
    parts = []
    stack = traceback.extract_stack(frame)
    for fs in stack:
        parts.append(f"{fs.name}@{fs.filename.rsplit('/', 1)[-1]}:{fs.lineno}")
    return ";".join(parts)


def cpu_profile(seconds: float = 2.0, hz: int = 100) -> str:
    """Sample all threads for `seconds`, emit collapsed-stack lines
    sorted by sample count (flamegraph.pl / speedscope compatible)."""
    seconds = max(0.1, min(seconds, 30.0))
    interval = 1.0 / max(1, min(hz, 1000))
    me = threading.get_ident()
    counts: Counter = Counter()
    samples = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            counts[_collapse(frame)] += 1
        samples += 1
        time.sleep(interval)
    lines = [
        f"# cpu profile: {samples} sampling passes over {seconds:.1f}s "
        f"({len(counts)} distinct stacks)"
    ]
    for stack, n in counts.most_common():
        lines.append(f"{stack} {n}")
    return "\n".join(lines) + "\n"


def render_snapshot(snap, top: int = 40) -> str:
    """The heap profile's text of one tracemalloc snapshot."""
    stats = snap.statistics("lineno")[:top]
    total = sum(s.size for s in snap.statistics("filename"))
    lines = [f"# heap: {total / 1024:.1f} KiB traced, top {len(stats)} sites"]
    for s in stats:
        lines.append(f"{s.traceback} size={s.size} count={s.count}")
    return "\n".join(lines) + "\n"


def heap_profile(top: int = 40, seconds: float = 1.0) -> str:
    import tracemalloc

    started = not tracemalloc.is_tracing()
    if started:
        tracemalloc.start()
        time.sleep(max(0.0, min(seconds, 30.0)))
    try:
        snap = tracemalloc.take_snapshot()
    finally:
        if started:
            tracemalloc.stop()
    return render_snapshot(snap, top)
