"""The differentiable processor against st_ito_tpu's: the noise-shaped
reverb's IR noise (the Threefry bits bit for bit, the normals), its IR and
reverb, and every function of ``proc.py`` in value and gradient. Gradient
ITO itself is ``test_torch_autodiff_run.py``.

Tolerances: values within 1e-5 x max(1, peak); gradients within 1e-3 x
the largest component, elementwise, and 1e-3 in relative L2. The normals
within 5e-5 absolute: torch's float32 inverse error function lies up to
2.1e-5 from XLA's. A function with the compressor in it within 1e-4 x
max(1, peak): its detector's release coefficient lies within 1e-4 of 1 at
its longest times, where the port's doubling scan and XLA's associative
scan each lie up to 5e-4 from a float64 run (ROADMAP §3 says the same of
the noise gate); ``test_compressor_float64_witness`` holds the port
there. The JAX functions run jitted (an eager associative scan takes
seconds)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu import proc as jproc
from st_ito_tpu.ops import reverb as jreverb

from st_ito_torch import proc
from st_ito_torch.ops import reverb

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 16384


def program(seed, shape):
    """Partials under a slow envelope over a noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SR
    x = 0.05 * rng.standard_normal(shape)
    for f0, a in ((110.0, 0.4), (330.0, 0.2), (1210.0, 0.1)):
        x = x + a * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28)) * (
            0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * t))
    return x.astype(np.float32)


def assert_values(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def assert_grads(got, want):
    """1e-3 x max|want| elementwise and 1e-3 in relative L2."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


# ------------------------------------------------------------ IR noise


@pytest.mark.parametrize("shape", [(2, 65536), (1, 32768), (3, 5)])
def test_threefry_bits_match_jax(shape):
    """``jax.random.bits(PRNGKey(4242), shape)`` bit for bit: the IR noise
    of ``proc.py`` (2 x 65536) and of the augmentation (1 x 32768)."""
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(4242), shape,
                                      jnp.uint32))
    np.testing.assert_array_equal(reverb.threefry_bits(4242, shape), want)


@pytest.mark.parametrize("shape", [(2, 65536), (1, 32768)])
def test_normals_match_jax(shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(4242), shape,
                                        jnp.float32))
    got = reverb._normal(4242, shape).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 5e-5


@pytest.mark.parametrize("ir_length,channels", [(65536, 2), (32768, 1)])
def test_noise_shaped_ir_matches_jax(ir_length, channels):
    """One IR against JAX's; a batch of three against three single ones."""
    rng = np.random.default_rng(ir_length)
    g, d = rng.random((2, 3, 12)).astype(np.float32)
    want = np.asarray(jreverb.noise_shaped_ir(jnp.asarray(g[0]),
                                              jnp.asarray(d[0]), SR,
                                              ir_length, channels))
    got = reverb.noise_shaped_ir(torch.from_numpy(g), torch.from_numpy(d),
                                 SR, ir_length, channels).numpy()
    assert got.shape == (3, channels, ir_length)
    assert_values(got[0], want)
    for i in (1, 2):
        one = reverb.noise_shaped_ir(torch.from_numpy(g[i]),
                                     torch.from_numpy(d[i]), SR, ir_length,
                                     channels).numpy()
        np.testing.assert_allclose(got[i], one, atol=1e-7, rtol=0)


def test_noise_shaped_reverb_matches_jax():
    rng = np.random.default_rng(3)
    x = program(4, (2, T))
    g, d = rng.random((2, 12)).astype(np.float32)
    want = jax.jit(jreverb.noise_shaped_reverb, static_argnums=(1,))(
        jnp.asarray(x), SR, jnp.asarray(g), jnp.asarray(d), 0.35)
    got = reverb.noise_shaped_reverb(torch.from_numpy(x), SR,
                                     torch.from_numpy(g),
                                     torch.from_numpy(d), 0.35)
    assert_values(got.numpy(), want)


# ------------------------------------------------------------- proc.py


PROC_FNS = {
    "apply_gain": 1, "apply_distortion": 1, "apply_compressor": 6,
    "apply_reverb": 25, "apply_parametric_eq": 18,
    "apply_parametric_eq_15": 15, "apply_simple_autodiff_processor": 21,
    "apply_complex_autodiff_processor": 51,
}
WITH_COMPRESSOR = ("apply_compressor", "apply_simple_autodiff_processor",
                   "apply_complex_autodiff_processor")


def proc_case(P):
    rng = np.random.default_rng(P)
    x = np.stack([program(1, (2, T)), program(2, (2, T))])
    return x, rng.uniform(0.05, 0.95, (2, P)).astype(np.float32), rng


@pytest.mark.parametrize("name", sorted(PROC_FNS))
def test_proc_matches_jax(name):
    """Each function on two examples at once, in value and in the gradient
    of sum(y * r) with respect to its [0, 1] parameters."""
    x, params, rng = proc_case(PROC_FNS[name])
    r = rng.standard_normal(x.shape).astype(np.float32)
    jfn, tfn = getattr(jproc, name), getattr(proc, name)

    def jloss(p):
        y = jfn(jnp.asarray(x), p, SR)
        return jnp.sum(y * jnp.asarray(r)), y

    (_, want_y), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(params))
    p = torch.tensor(params, requires_grad=True)
    y = tfn(torch.from_numpy(x), p, SR)
    (y * torch.from_numpy(r)).sum().backward()
    assert_values(y.detach().numpy(), want_y,
                  1e-4 if name in WITH_COMPRESSOR else 1e-5)
    assert_grads(p.grad.numpy(), want_g)


def _compressor64(x, p):
    """``apply_compressor`` in float64 numpy, its detector a loop."""
    x, p = x.astype(np.float64), p.astype(np.float64)
    out = []
    for xb, pb in zip(x, p):
        th, ratio, atk, rel, knee, makeup = (
            pb[i] * (hi - lo) + lo for i, (lo, hi) in enumerate(
                ((-60.0, 0.0), (1.0, 20.0), (0.1, 250.0), (10.0, 2000.0),
                 (1.0, 24.0), (0.0, 24.0))))
        env_db = 20.0 * np.log10(np.maximum(np.abs(xb).max(axis=0), 1e-8))
        over = env_db - th
        slope = 1.0 / ratio - 1.0
        c = np.where(2 * over < -knee, 0.0, np.where(
            2 * over > knee, slope * over,
            slope * (over + knee / 2) ** 2 / (2 * knee)))
        aa = np.exp(-1.0 / (atk * 1e-3 * SR))
        ar = np.exp(-1.0 / (rel * 1e-3 * SR))
        y1 = g = 0.0
        smooth = np.empty_like(c)
        for n, cn in enumerate(c):
            y1 = min(cn, ar * y1 + (1.0 - ar) * cn)
            g = aa * g + (1.0 - aa) * y1
            smooth[n] = g
        delayed = np.pad(xb, ((0, 0), (512, 0)))[:, :xb.shape[-1]]
        out.append(delayed * 10.0 ** ((smooth + makeup) / 20.0))
    return np.stack(out)


def test_compressor_float64_witness():
    """On ``test_proc_matches_jax``'s compressor case (release times of
    780 and 330 ms) the port lies no farther from a float64 compressor
    than the JAX package does."""
    x, params, _ = proc_case(PROC_FNS["apply_compressor"])
    want = np.asarray(jax.jit(jproc.apply_compressor, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(params), SR))
    got = proc.apply_compressor(torch.from_numpy(x),
                                torch.from_numpy(params), SR).numpy()
    ref = _compressor64(x, params)
    assert np.abs(got - ref).max() <= np.abs(want - ref).max()


def test_processor_counts_match_jax():
    for k in ("NUM_SIMPLE_PARAMS", "NUM_COMPLEX_PARAMS", "NUM_REVERB_PARAMS"):
        assert getattr(proc, k) == getattr(jproc, k)
