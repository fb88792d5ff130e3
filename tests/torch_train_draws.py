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

import jax
import jax.numpy as jnp
import numpy as np
import torch


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
