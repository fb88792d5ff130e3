"""Test helper: the port's random draws handed to the JAX package.

``record_draws(generator)`` records, in call order, every ``torch.rand``
and ``torch.randint`` drawn from ``generator`` while the port runs;
``replay_draws(draws)`` then replaces ``jax.random.uniform``,
``jax.random.bernoulli`` and ``jax.random.randint`` while a JAX function
traces, each call taking the next recorded draw: a uniform its values
scaled to [minval, maxval), a Bernoulli mask ``u < p`` of the port's
uniforms, a randint the port's integers. Nothing in the JAX package
changes: its module-level ``jax.random`` attributes are replaced for the
duration and restored. JAX's own internal draws (``jax._src.random``) are
not touched.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch


# XLA options for the tests' jitted JAX steps: LLVM's optimisation off.
# A training step's program compiles in about two thirds of the CPU time;
# it runs a few times, a little slower. How far its results lie from the
# default-compiled program's is read by ``reference_jit``'s readings mode.
FAST_COMPILE = {"xla_backend_optimization_level": "0",
                "xla_llvm_disable_expensive_passes": True}
READINGS_ENV = "ST_ITO_COMPILE_READINGS"


def reference_jit(fn, static_argnums=()):
    """``jax.jit(fn)`` compiled with FAST_COMPILE, for a test's JAX
    reference. With the environment variable ST_ITO_COMPILE_READINGS set to
    a file, each call traces fn once and compiles it twice, with
    FAST_COMPILE and with XLA's defaults, returns the FAST_COMPILE result,
    and appends one JSON line to the file: the test, fn, each
    floating-point output's largest absolute difference between the two
    programs and its peak, and the count of integer outputs that differ."""
    jitted = jax.jit(fn, static_argnums=static_argnums,
                     compiler_options=FAST_COMPILE)
    path = os.environ.get(READINGS_ENV)
    if not path:
        return jitted
    static = ({static_argnums} if isinstance(static_argnums, int)
              else set(static_argnums))
    plain = jax.jit(fn, static_argnums=static_argnums)

    def both(*args):
        lowered = plain.lower(*args)
        dynamic = [a for i, a in enumerate(args) if i not in static]
        got = lowered.compile(FAST_COMPILE)(*dynamic)
        want = lowered.compile()(*dynamic)
        reading = {"test": os.environ.get("PYTEST_CURRENT_TEST"),
                   "fn": getattr(fn, "__qualname__", repr(fn)),
                   "int_mismatch": 0, "leaves": {}}
        for (key, g), w in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves(want)):
            g, w = np.asarray(g), np.asarray(w)
            if not np.issubdtype(w.dtype, np.floating):
                reading["int_mismatch"] += int(not np.array_equal(g, w))
                continue
            d = float(np.abs(g.astype(np.float64) - w).max(initial=0.0))
            peak = float(np.abs(w.astype(np.float64)).max(initial=0.0))
            reading["leaves"][jax.tree_util.keystr(key)] = (d, peak)
        with open(path, "a") as f:
            f.write(json.dumps(reading) + "\n")
        return got

    return both


@contextlib.contextmanager
def record_draws(generator):
    draws = []
    rand, randint = torch.rand, torch.randint

    def rec_rand(*shape, generator=None, **kw):
        out = rand(*shape, generator=generator, **kw)
        if generator is not None and generator is target:
            draws.append(("rand", out.detach().cpu().numpy().copy()))
        return out

    def rec_randint(*a, generator=None, **kw):
        out = randint(*a, generator=generator, **kw)
        if generator is not None and generator is target:
            draws.append(("randint", out.detach().cpu().numpy().copy()))
        return out

    target = generator
    torch.rand, torch.randint = rec_rand, rec_randint
    try:
        yield draws
    finally:
        torch.rand, torch.randint = rand, randint


@contextlib.contextmanager
def replay_draws(draws):
    queue = list(draws)
    used = []
    saved = (jax.random.uniform, jax.random.bernoulli, jax.random.randint)

    def take(kind, shape):
        assert queue, f"JAX drew a {kind} {shape} beyond the port's draws"
        got_kind, v = queue.pop(0)
        assert got_kind == ("randint" if kind == "randint" else "rand"), \
            (kind, got_kind)
        assert tuple(v.shape) == tuple(shape), (kind, v.shape, shape)
        used.append(kind)
        return v

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = jnp.asarray(take("uniform", shape), jnp.float32)
        return (minval + u * (maxval - minval)).astype(dtype)

    def bernoulli(key, p=0.5, shape=None):
        return jnp.asarray(take("bernoulli", shape) < p)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(take("randint", shape), dtype)

    jax.random.uniform, jax.random.bernoulli, jax.random.randint = (
        uniform, bernoulli, randint)
    try:
        yield used
    finally:
        jax.random.uniform, jax.random.bernoulli, jax.random.randint = saved
    assert not queue, f"{len(queue)} port draws left unused"


def as_torch_batch(batch, dtype_map=None):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
