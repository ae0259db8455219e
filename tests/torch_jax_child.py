"""Run a test module's JAX side once a test session and share its JSON.

Under `pytest -n N --dist load` a module's tests are spread over the workers,
and every worker that draws one of them builds the module's fixtures. For a
fixture that computes the JAX side (a child process on XLA:CPU, minutes and
gigabytes), that is one computation a worker of the same seeded inputs. This
helper computes it once for the whole session:

- the first worker to ask takes an exclusive `fcntl.flock` on a file under
  the session's shared temp root, runs `compute()` and writes its JSON there;
- every other worker waits on the lock and reads that JSON;
- a failed computation is written beside it, so every worker's fixture fails
  with the same message.

The file is keyed by the module's name and a hash of the test module's
source, so an edited test never reads a stale result. Without xdist the root
is the session's basetemp, and the helper is a plain call.
"""

import fcntl
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def _root(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    root = root / "jax_children"
    root.mkdir(parents=True, exist_ok=True)
    return root


def shared(tmp_path_factory, module_file, compute, tag=""):
    """`compute()`'s JSON-able result, computed once a session for
    `module_file` (a test module's path) and `tag`."""
    path = Path(module_file)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
    stem = f"{path.stem}{'-' + tag if tag else ''}-{digest}"
    root = _root(tmp_path_factory)
    done, failed = root / f"{stem}.json", root / f"{stem}.err"
    with open(root / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if failed.exists():
                raise AssertionError(failed.read_text())
            if not done.exists():
                try:
                    text = json.dumps(compute())
                except BaseException as exc:
                    failed.write_text(f"{type(exc).__name__}: {exc}")
                    raise
                tmp = root / f"{stem}.tmp"
                tmp.write_text(text)
                tmp.replace(done)
            return json.loads(done.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def child_json(module, entry, env_updates, timeout=1200):
    """Run `module.entry()` in a child Python with `tests/` and the repo on
    its path and `env_updates` in its environment; its last line of standard
    output, parsed. A child that fails raises with its stderr."""
    env = dict(os.environ)
    env.update(env_updates)
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
        f"import {module}; {module}.{entry}()"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent)],
        capture_output=True, text=True, env=env, timeout=timeout, check=False,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
