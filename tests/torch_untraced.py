"""An autouse fixture for the port's CPU-heavy test modules: a module's tests
and fixtures run with `tracemalloc` off.

Another test of the suite may leave allocation tracing on in its worker
process (the JAX package's heap profile starts it and keeps it on), which
makes big-integer and tensor-heavy Python many times slower for every later
test on that worker. The fixture stops tracing it finds on and leaves it
off: the trace is what that earlier test leaked, and no later test reads it
(a heap profile starts tracing again itself when it is off). Import the
fixture into a module to use it:

    from torch_untraced import untraced  # noqa: F401
"""

import tracemalloc

import pytest


@pytest.fixture(autouse=True, scope="module")
def untraced():
    if tracemalloc.is_tracing():
        tracemalloc.stop()
    yield
