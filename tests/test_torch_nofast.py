"""The differentiable population renderer, ``build_batched_render_fn(...,
fast=False)``, against st_ito_tpu's (its plan off the TPU, where
``fast=False`` and ``"auto"`` mean the per-stage response path and the
parallel scans): the basic chain with ``fuse_lti`` on and off, the fx chain
and the reference style chain (EQ -> multiband compressor -> limiter), as
``tests/test_batched_render.py`` and ``tests/test_multiband_json.py``
render them; gradients through it; and no kernel wrapper reached on the
way.

The JAX renderers run op by op with their scans jitted (``jit_jax_scans``;
an outer jit rounds the delay differently, ROADMAP §3). Tolerances, after
peak normalisation: atol 5e-5, rtol 1e-4; on the fx chain with one sine
and one detector (``test_torch_fx.py`` says why)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.chain import basic_chain as jax_basic_chain
from st_ito_tpu.chain import chain_from_json as jax_chain_from_json
from st_ito_tpu.chain.executor import (
    build_batched_render_fn as jax_build_batched_render_fn,
)

from st_ito_torch.chain import (basic_chain, build_batched_render_fn,
                                chain_from_json)
from st_ito_torch.ops.kernels import (eqcomp, fused_fft, mega_fft,
                                      packed_response, scan)

from tests.test_torch_fx import (FX, _audio, _population, fx_chain,
                                 jit_jax_scans, one_detector, one_sine)
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
STYLE = "chains/eq+multiband-comp+limiter.json"


def no_kernels(monkeypatch):
    """Every kernel wrapper's plain and CUDA functions raise: on a CPU
    tensor each wrapper calls its plain version, so a render that reaches
    a wrapper fails."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"fast=False reached {name}")
        return fn

    for mod in (eqcomp, fused_fft, mega_fft, packed_response, scan):
        for name in dir(mod):
            if name.endswith(("_plain", "_cuda")) and callable(
                    getattr(mod, name)):
                monkeypatch.setattr(mod, name, refuse(name))


def _render_pair(monkeypatch, chain, jchain, W, x, **kw):
    """(port, JAX) renders of W on x with fast=False, the port's with no
    kernel reachable."""
    jit_jax_scans(monkeypatch)
    want = np.asarray(jax_build_batched_render_fn(
        jchain, SR, x.shape[0], fast=False, **kw)(jnp.asarray(W),
                                                  jnp.asarray(x)))
    with monkeypatch.context() as mp:
        no_kernels(mp)
        got = build_batched_render_fn(chain, SR, x.shape[0], fast=False,
                                      device="cpu", **kw)(
            torch.from_numpy(W), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return got, want


def test_no_kernels_watch_catches_the_fast_renderer(monkeypatch):
    """The watch above is live: the fast renderer trips it."""
    no_kernels(monkeypatch)
    x = torch.from_numpy(_audio(1, (2, 2048)))
    W = torch.from_numpy(_population(basic_chain(), 2, 2))
    with pytest.raises(AssertionError, match="fast=False reached"):
        build_batched_render_fn(basic_chain(), SR, 2, device="cpu")(W, x)


@pytest.mark.parametrize("fuse_lti", [True, False])
@pytest.mark.parametrize("with_bypass", [False, True])
def test_basic_chain_matches_jax(monkeypatch, fuse_lti, with_bypass):
    """EQ (in the LTI group), compressor, distortion, then delay and reverb
    (one group, or each its own with ``fuse_lti=False``), on a mono input
    shared by the population (promoted to stereo at the reverb)."""
    x = _audio(3, (1, 8192))
    chain = basic_chain(with_bypass=with_bypass)
    W = _population(chain, 4, 4)
    got, want = _render_pair(monkeypatch, chain,
                             jax_basic_chain(with_bypass=with_bypass), W, x,
                             fuse_lti=fuse_lti)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_fx_chain_matches_jax(monkeypatch):
    """The fx chain (49 parameters): EQ, the gate's parallel detector, the
    chorus, the phaser's doubling scans, then gain -> widener -> delay ->
    reverb as one response group."""
    one_sine(monkeypatch)
    one_detector(monkeypatch)
    x = _audio(5, (2, 4096))
    W = _population(fx_chain(), 4, 6)
    got, want = _render_pair(monkeypatch, fx_chain(), fx_chain(jax=True), W,
                             x)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_style_chain_matches_jax(monkeypatch):
    """EQ -> multiband compressor (its crossovers by FFT, three linked
    compressors op by op) -> limiter."""
    x = _audio(7, (2, 8192))
    chain = chain_from_json(STYLE)
    W = np.random.default_rng(8).uniform(
        0.2, 0.8, (3, chain.num_params)).astype(np.float32)
    got, want = _render_pair(monkeypatch, chain, jax_chain_from_json(STYLE),
                             W, x)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("names", [("basic",), FX], ids=["basic", "fx"])
def test_gradients_are_finite_and_nonzero(monkeypatch, names):
    """d mean(render^2) / dW through the whole chain, every stage's
    parameters reached, with no kernel reachable."""
    no_kernels(monkeypatch)
    chain = basic_chain() if names == ("basic",) else fx_chain(
        with_bypass=False)
    x = torch.from_numpy(_audio(9, (2, 4096)))
    W = torch.full((2, chain.num_params), 0.5, requires_grad=True)
    render = build_batched_render_fn(chain, SR, 2, fast=False,
                                     peak_normalize_output=False,
                                     device="cpu")
    torch.mean(render(W, x) ** 2).backward()
    g = W.grad
    assert torch.isfinite(g).all()
    for _, start, end in chain.stage_slices():
        assert g[:, start:end].abs().max() > 0
