"""The port's population renderer against st_ito_tpu's, with the JAX side
forced onto its TPU plan (``fft_mode="mx"``: K1, then the four-step FFT
around K9) and its Pallas kernels run in interpret mode."""

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
from st_ito_tpu.ops.pallas import packed_response as jax_packed_response
from st_ito_tpu.ops.pallas import scan as jax_scan

from st_ito_torch.chain import basic_chain, build_batched_render_fn

SR = 48000


def force_jax_tpu_plan(monkeypatch):
    """Make st_ito_tpu render with its TPU plan on the CPU: the backend
    reads as "tpu" and the two Pallas kernels of the mx plan run in
    interpret mode. packed_lti_apply_rp is patched (not
    packed_response_apply_rp, which it calls with interpret=False)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(
        jax_scan, "eq_compressor_fused_pallas",
        functools.partial(jax_scan.eq_compressor_fused_pallas,
                          interpret=True))
    monkeypatch.setattr(
        jax_packed_response, "packed_lti_apply_rp",
        functools.partial(jax_packed_response.packed_lti_apply_rp,
                          interpret=True))


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


def test_render_matches_jax_mx_plan(monkeypatch):
    force_jax_tpu_plan(monkeypatch)
    B, T = 4, 8192
    x = np.random.default_rng(3).standard_normal((2, T)).astype(np.float32)
    chain = basic_chain()
    jax_render = jax.jit(jax_build_batched_render_fn(
        jax_basic_chain(), SR, 2, fast=True, fft_mode="mx"))
    render = build_batched_render_fn(chain, SR, 2, fft_mode="mx",
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


@pytest.mark.parametrize("kwargs", [
    {"fft_mode": "auto"}, {"fft_mode": "mega2"}, {"fast": False},
    {"fuse_lti": False}, {"out_rows_hop": 1024}, {"fft_precision": "mixed"},
])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_batched_render_fn(basic_chain(), SR, 2, device="cpu", **kwargs)
