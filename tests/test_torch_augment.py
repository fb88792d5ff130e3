"""The port's paired transforms (``augment.py``) against st_ito_tpu's:
every transform of ALL_TRANSFORMS with the port's draws handed to the
JAX trace (``torch_train_draws``), applied (p = 1) and skipped (p = 0),
and ``apply_paired``'s pairing."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_train_draws import record_draws, replay_draws  # noqa: E402

from st_ito_tpu import augment as jaug

from st_ito_torch import augment as taug

torch.set_num_threads(1)
T = 4096


def signal(seed=15):
    return (np.random.default_rng(seed).standard_normal((2, T)) * 0.4
            ).astype(np.float32)


def test_the_transforms_are_the_jax_list():
    assert list(taug.ALL_TRANSFORMS) == list(jaug.ALL_TRANSFORMS)


@pytest.mark.parametrize("name", sorted(jaug.ALL_TRANSFORMS))
def test_transform_matches_jax(name):
    """Applied (p = 1): within 1e-4 x the output's peak, the same draws in
    the same order; skipped (p = 0): the input itself."""
    x = signal()
    for p in (1.0, 0.0):
        g = torch.Generator().manual_seed(3)
        with record_draws(g) as draws:
            got = taug.ALL_TRANSFORMS[name](g, torch.from_numpy(x), p=p)
        with replay_draws(draws):
            want = np.asarray(jax.jit(
                lambda a: jaug.ALL_TRANSFORMS[name](jax.random.PRNGKey(0), a,
                                                    p=p))(jnp.asarray(x)))
        got = got.numpy()
        assert got.shape == x.shape and np.isfinite(got).all()
        if p == 0.0:
            assert np.array_equal(got, x)
            continue
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_apply_paired_gives_both_the_same_draws():
    x = torch.from_numpy(signal(1))
    g = torch.Generator().manual_seed(7)
    a, b = taug.apply_paired(g, x, x.clone(), transforms=[
        "parametric_eq", "compressor", "reverb", "sox_reverb", "gain"])
    assert torch.equal(a, b)
    g2 = torch.Generator().manual_seed(8)
    c, _ = taug.apply_paired(g2, x, x.clone(), transforms=["gain", "pan"])
    assert not torch.equal(a, c)
