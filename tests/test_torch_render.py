"""The port's population renderer against st_ito_tpu's, with the JAX side
forced onto its TPU plan and its Pallas kernels run in interpret mode:
``fft_mode="mx"`` (K1, then the four-step FFT around K9), ``"mega2"``
(K1, K3 -> K4, what ``"auto"`` picks), ``"mega"`` (K1, K5 -> K2 -> K4) and
``"fused"`` (K1, K10 -> K9 -> K10)."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import basic_chain as jax_basic_chain
from st_ito_tpu.chain.executor import (
    build_batched_render_fn as jax_build_batched_render_fn,
)
from st_ito_tpu.ops.pallas import mega_fft as jax_mega_fft
from st_ito_tpu.ops.pallas import packed_response as jax_packed_response
from st_ito_tpu.ops.pallas import scan as jax_scan

from st_ito_torch.chain import basic_chain, build_batched_render_fn
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def force_jax_tpu_plan(monkeypatch):
    """Make st_ito_tpu render with its TPU plan on the CPU: the backend
    reads as "tpu" and the Pallas kernels of the mx, fused, mega and mega2
    plans and of the chains' lone EQ (K6), unlinked compressors (K7) and
    linked compressors (K8) run in interpret mode. packed_lti_apply_rp is
    patched (not packed_response_apply_rp or fft_fused, which it calls
    with its own interpret flag), and so are the two mega group functions
    the executor calls."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for name in ("eq_compressor_fused_pallas", "biquad_cascade_pallas",
                 "compressor_fused_pallas", "ballistics_pallas"):
        monkeypatch.setattr(
            jax_scan, name,
            functools.partial(getattr(jax_scan, name), interpret=True))
    monkeypatch.setattr(
        jax_packed_response, "packed_lti_apply_rp",
        functools.partial(jax_packed_response.packed_lti_apply_rp,
                          interpret=True))
    for name in ("packed_lti_apply_mega", "packed_lti_apply_mega2"):
        monkeypatch.setattr(
            jax_mega_fft, name,
            functools.partial(getattr(jax_mega_fft, name), interpret=True))


def population(B, seed):
    """(B, 36) raw vectors with each stage bypassed in some candidate and
    active in the others."""
    chain = basic_chain()
    W = np.random.default_rng(seed).uniform(
        0.1, 0.9, (B, chain.num_params)).astype(np.float32)
    starts = [s for _, s, _ in chain.stage_slices()]
    W[:, starts] = 0.2
    for i, s in enumerate(starts):
        W[i % B, s] = 0.8
    return W


def _assert_render_matches_jax(monkeypatch, fft_mode, B, jit, T=8192):
    """Both renderers on one population, twice: the distortion bypassed in
    every candidate (flat 5e-5), then on where W says so (5e-5 x drive).

    ``jit=False`` runs the JAX renderer op by op, as the port runs. Under an
    outer jit XLA fuses the delay's denormalisation with the multiplication
    by the sample rate and rounds D = delay_seconds * sr one float32 ulp
    differently for candidates 5 and 6 of the B = 8 population (0.0039
    samples at D = 33138.77); through the feedback 0.87 comb that is 1e-2
    in the output, in the mx plan as much as in the mega ones. The B = 4
    population of the mx test has no such candidate."""
    force_jax_tpu_plan(monkeypatch)
    x = np.random.default_rng(3).standard_normal((2, T)).astype(np.float32)
    chain = basic_chain()
    jax_render = jax_build_batched_render_fn(
        jax_basic_chain(), SR, 2, fast=True, fft_mode=fft_mode)
    if jit:
        jax_render = jax.jit(jax_render)
    render = build_batched_render_fn(chain, SR, 2, fft_mode=fft_mode,
                                     device="cpu")

    def both(W):
        want = np.asarray(jax_render(jnp.asarray(W), jnp.asarray(x)))
        got = render(torch.from_numpy(W), torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (B, 2, T)
        assert np.isfinite(got).all()
        return np.abs(got - want).max(axis=(1, 2))

    W = population(B, 4)
    dist, d_start, _ = chain.stage_slices()[2]
    # every stage but the distortion, in every candidate: flat 5e-5
    W_nodist = W.copy()
    W_nodist[:, d_start] = 0.8
    err = both(W_nodist)
    assert np.all(err <= 5e-5), err
    # the distortion on where W says so: tanh(drive * y) multiplies the
    # float32 rounding of its input y by up to drive (35 dB = 56x for
    # candidate 1 here), so only the candidates it processes get 5e-5 x drive
    drive_db = dist.params[0].denormalize(W[:, d_start + 1])
    drive = np.where(W[:, d_start] <= 0.5,
                     np.maximum(1.0, 10.0 ** (drive_db / 20.0)), 1.0)
    err = both(W)
    assert np.all(err <= 5e-5 * drive), (err, drive)


def test_render_matches_jax_mx_plan(monkeypatch):
    _assert_render_matches_jax(monkeypatch, "mx", B=4, jit=True)


def test_render_matches_jax_fused_plan(monkeypatch):
    """K10 -> K9 -> K10 here, fft_fused -> K9 -> fft_fused interpreted
    there: T 8192 gives n = 2^14, the smallest size ``supported`` admits;
    the split tolerance of the other plans."""
    from st_ito_torch.ops.kernels import fused_fft

    assert fused_fft.supported(16384, 8192)
    _assert_render_matches_jax(monkeypatch, "fused", B=4, jit=False)


@pytest.mark.parametrize("fft_mode", ["mega2", "mega"])
def test_render_matches_jax_mega_plans(monkeypatch, fft_mode):
    """B = 8 so that the JAX gate B % 8 == 0 takes its mega branch; T 8192
    gives n = 2^14, the smallest size the mega path admits. Same split
    tolerance as the mx plan."""
    assert jax_mega_fft.supported(16384, 8192)
    _assert_render_matches_jax(monkeypatch, fft_mode, B=8, jit=False)


def test_auto_is_mega2_by_default(monkeypatch):
    """``fft_mode`` defaults to "auto", which runs the mega2 group (K3 ->
    K4) wherever ``supported`` admits the shape, and no other group."""
    from st_ito_torch.chain import executor
    from st_ito_torch.ops.kernels import mega_fft

    calls = []
    for name in ("packed_lti_apply_mega2", "packed_lti_apply_mega"):
        real = getattr(mega_fft, name)
        monkeypatch.setattr(
            mega_fft, name,
            lambda *a, _real=real, _name=name: (calls.append(_name),
                                                _real(*a))[1])
    monkeypatch.setattr(
        executor, "packed_lti_apply_rp",
        lambda *a: pytest.fail("auto took the mx path on a supported shape"))
    T = 8192
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, T)).astype(np.float32))
    W = torch.from_numpy(population(2, 6))
    chain = basic_chain()
    got = build_batched_render_fn(chain, SR, 2, device="cpu")(W, x)
    assert calls == ["packed_lti_apply_mega2"]
    want = build_batched_render_fn(chain, SR, 2, fft_mode="mega2",
                                   device="cpu")(W, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fft_mode", ["mega2", "mega", "auto", "fused",
                                      "mx3"])
def test_unsupported_shape_takes_the_mx_path(fft_mode):
    """T = 1000 gives n = 2048, below the 128 x 128 split, so ``supported``
    rejects it and the mega and fused modes run the mx path: the same code,
    bit for bit."""
    from st_ito_torch.ops.kernels import fused_fft, mega_fft

    T = 1000
    assert not mega_fft.supported(2048, T)
    assert not fused_fft.supported(2048, T)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, T)).astype(np.float32))
    W = torch.from_numpy(population(3, 6))
    chain = basic_chain()
    got = build_batched_render_fn(chain, SR, 2, fft_mode=fft_mode,
                                  device="cpu")(W, x)
    want = build_batched_render_fn(chain, SR, 2, fft_mode="mx",
                                   device="cpu")(W, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kwargs", [
    {"out_rows_hop": 1024}, {"fft_precision": "mixed"},
], ids=["kwargs3", "kwargs4"])  # as they were
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_batched_render_fn(basic_chain(), SR, 2, device="cpu", **kwargs)
