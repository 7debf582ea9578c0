"""A persistent XLA compilation cache for the port's tests: every test
file that runs the JAX reference imports :func:`compile_cache`, an
autouse fixture.

The reference runs eagerly, op by op, and builds fresh ``jax.jit``
closures for each store, engine and trainer, so the test processes
compile the same small XLA programs again and again: on the CPU the
compiles are most of the reference side's time.  The cache is keyed by
the program (its HLO, the compile options, the backend), not by the
Python function, so an identical program loads the executable compiled
the first time, in any worker of the run: the same machine code, so no
result changes.  Every program is cached, however quick its compile."""

import os

import pytest


@pytest.fixture(scope="session", autouse=True)
def compile_cache(tmp_path_factory):
    """JAX's compilation cache in this run's temporary tree: shared by the
    run's xdist workers (the parent of each worker's base directory) and
    removed with the run's other temporary files by pytest's retention of
    the last base directories.  A cache directory set before
    (``JAX_COMPILATION_CACHE_DIR``) is left as it is."""
    import jax

    if not jax.config.jax_compilation_cache_dir:
        base = tmp_path_factory.getbasetemp()
        path = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / "jax-cache"
        path.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        # The reference's subprocesses (``torch_mesh_ref.py``) read the same
        # cache through the environment they inherit.
        os.environ["JAX_COMPILATION_CACHE_DIR"] = str(path)
        os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    yield
