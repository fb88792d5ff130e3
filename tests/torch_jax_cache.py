"""Test helper: one persistent XLA compilation cache for the port's parity
tests.

The JAX side of ``tests/test_torch_*.py`` compiles the same programs again
and again: ``tests/conftest.py`` clears JAX's in-memory caches every 40
tests of a worker, and each of the suite's workers compiles the shared
references (the small Cnn14, the renderers, the trainers' steps) for
itself. ``shared_compile_cache`` (autouse, module scope; each port test
module imports it) points JAX's persistent compilation cache, the one
``st_ito_tpu/compile_cache.py`` turns on for the JAX CLIs, at one
directory under the session's temporary root for the module's duration,
and restores JAX's settings after it, so the JAX package's own tests run
as before. A hit returns the executable XLA compiled for the same program
and options: no result changes. A read that fails (an entry another
worker is still writing) compiles afresh, as JAX does by itself.
"""

import os

import jax
import pytest
from jax._src import compilation_cache

# every compile, however short: most repeats are of small programs
MIN_COMPILE_SECS = 0.0
_KEYS = ("jax_compilation_cache_dir",
         "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(autouse=True, scope="module")
def shared_compile_cache(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the session's root, shared by its workers
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    jax.config.update("jax_compilation_cache_dir",
                      str(root / "jax_compilation_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
