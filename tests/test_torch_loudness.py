"""The port's BS.1770 loudness (``st_ito_torch/ops/loudness.py``) and the
batch helpers of ``st_ito_torch/utils.py`` against st_ito_tpu's: the
K-weighting within rtol 1e-5, integrated LUFS within 1e-3 LU, the -3.01
LUFS sine calibration of ``tests/test_stft_loudness.py``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu import utils as jax_utils
from st_ito_tpu.ops import loudness as jax_loudness

from st_ito_torch import utils
from st_ito_torch.ops import loudness
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def _signal(seed, shape, T):
    """Noise under a slow envelope, with a quiet stretch that the gates
    drop."""
    rng = np.random.default_rng(seed)
    env = np.ones(T, np.float32)
    env[T // 3:T // 2] = 1e-4
    return (rng.standard_normal(shape + (T,)).astype(np.float32) * 0.1
            * env)


@pytest.mark.parametrize("sr", [44100, 48000])
def test_k_weighting_matches_jax(sr):
    b, a = loudness._k_weighting_sos(sr)
    jb, ja = jax_loudness._k_weighting_sos(sr)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    x = _signal(1, (2,), 24000)
    got = loudness.k_weight(torch.from_numpy(x), sr).numpy()
    want = np.asarray(jax_loudness.k_weight(jnp.asarray(x), sr))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,T", [((2,), 3 * SR), ((3, 2), SR),
                                     ((1,), 8192)])
def test_integrated_loudness_matches_jax(shape, T):
    x = _signal(2, shape, T)
    got = loudness.integrated_loudness(torch.from_numpy(x), SR).numpy()
    want = np.asarray(jax_loudness.integrated_loudness(jnp.asarray(x), SR))
    assert got.shape == want.shape == shape[:-1]
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_lufs_sine_calibration():
    """BS.1770: a 997 Hz 0 dBFS sine in one channel reads -3.01 LKFS."""
    T = 5 * SR
    t = np.arange(T) / SR
    x = np.stack([np.sin(2 * np.pi * 997 * t), np.zeros(T)]).astype(
        np.float32)
    lufs = float(loudness.integrated_loudness(torch.from_numpy(x), SR))
    np.testing.assert_allclose(lufs, -3.01, atol=0.1)
    assert abs(lufs - float(jax_loudness.integrated_loudness(
        jnp.asarray(x), SR))) <= 1e-3


def test_silence_reads_the_floor():
    """Silence reads the mean-square floor, -0.691 + 10 log10(1e-12)."""
    got = float(loudness.integrated_loudness(torch.zeros(2, SR), SR))
    want = float(jax_loudness.integrated_loudness(jnp.zeros((2, SR)), SR))
    np.testing.assert_allclose(got, -120.691, atol=1e-3)
    assert got == want


def test_loudness_normalize_and_batch_helpers_match_jax():
    x = _signal(3, (2, 2), 2 * SR)
    got = loudness.loudness_normalize(torch.from_numpy(x), SR, -22.0)
    np.testing.assert_allclose(
        loudness.integrated_loudness(got, SR).numpy(), -22.0, atol=0.2)
    want = np.asarray(jax_loudness.loudness_normalize(jnp.asarray(x), SR,
                                                      -22.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(
        utils.batch_loudness_normalize(torch.from_numpy(x), SR, -18.0)
        .numpy(),
        np.asarray(jax_utils.batch_loudness_normalize(jnp.asarray(x), SR,
                                                      -18.0)),
        rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(
        utils.batch_peak_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_utils.batch_peak_normalize(jnp.asarray(x))),
        rtol=1e-6)
    for n in (1000, 10 ** 6):
        np.testing.assert_allclose(
            utils.apply_fade_in(torch.from_numpy(x), n).numpy(),
            np.asarray(jax_utils.apply_fade_in(jnp.asarray(x), n)),
            rtol=1e-6, atol=1e-7)
