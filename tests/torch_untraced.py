"""An autouse fixture for the port's CPU-heavy test modules: a module's tests
and fixtures run with `tracemalloc` off, and the tracing state the module
found is put back after it.

Another test of the suite may leave allocation tracing on in its worker
process (the JAX package's heap profile starts it and keeps it on), which
makes big-integer and tensor-heavy Python several times slower for every
later test on that worker. Import the fixture into a module to use it:

    from torch_untraced import untraced  # noqa: F401
"""

import tracemalloc

import pytest


@pytest.fixture(autouse=True, scope="module")
def untraced():
    tracing = tracemalloc.is_tracing()
    if tracing:
        frames = tracemalloc.get_traceback_limit()
        tracemalloc.stop()
    yield
    if tracing:
        tracemalloc.start(frames)
