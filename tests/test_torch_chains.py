"""The port's K6, K7 and K8 chains against st_ito_tpu: the reference style
chain (EQ -> multiband compressor -> limiter, K6 then K8), the CLI's vst
chain (EQ -> delay -> reverb, K6 then K3 -> K4), the single-compressor chain
(K7) and the presets; the
ops under them (multiband compressor, limiter, linked fast compressor,
widener, gain, resampler); the registry (``chain_from_json``,
``chain_preset``); ``build_render_fn`` and ``make_fitness_fn(
normalize_stages=True)``.

The JAX renderer runs its TPU plan with its Pallas kernels in interpret
mode (``force_jax_tpu_plan``), op by op, as the port runs (under an outer
jit XLA rounds the delay one ulp differently, ROADMAP §3). Tolerances: a flat
5e-5 after peak normalisation for a whole render, 5e-5 x drive for the
candidates the distortion processes (tanh(drive * y) multiplies the
rounding of y by up to the drive), as ``test_torch_render.py`` holds; atol
2e-5, rtol 1e-4 for one op, the class of ``test_torch_process.py``."""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import effects as jeffects
from st_ito_tpu.chain.executor import (
    build_batched_render_fn as jax_build_batched_render_fn,
)
from st_ito_tpu.chain.executor import build_render_fn as jax_build_render_fn
from st_ito_tpu.ito.engine import make_fitness_fn as jax_make_fitness_fn
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.registry import ParamModel as JaxParamModel
from st_ito_tpu.models.registry import get_param_embeds as jax_embeds
from st_ito_tpu.ops import dynamics as jdyn
from st_ito_tpu.ops import multiband as jmb
from st_ito_tpu.ops.resample import resample as jax_resample
from st_ito_tpu.ops import stereo as jst

from st_ito_torch.chain import (ChainSpec, build_batched_render_fn,
                                build_render_fn, chain_from_json, chain_preset)
from st_ito_torch.chain import effects as teffects
from st_ito_torch.ito import make_fitness_fn
from st_ito_torch.models import get_param_embeds
from st_ito_torch.ops import dynamics as tdyn
from st_ito_torch.ops import multiband as tmb
from st_ito_torch.ops.resample import resample
from st_ito_torch.ops import stereo as tst
from st_ito_torch.ops.kernels import scan

from tests.test_torch_cnn14 import SMALL, jax_params, port_model
from tests.test_torch_render import force_jax_tpu_plan
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
STYLE_JSON = "chains/eq+multiband-comp+limiter.json"
PRESETS = ("general", "simple", "speech", "mastering", "vocals", "guitar")
ATOL, RTOL = 2e-5, 1e-4


def _audio(seed, shape):
    """Noise under a slow envelope, peak 0.9: the compressors see both
    sides of their thresholds."""
    rng = np.random.default_rng(seed)
    T = shape[-1]
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * np.arange(T) / T)
    x = rng.standard_normal(shape) * env
    return (0.9 * x / np.abs(x).max()).astype(np.float32)


def _population(chain, B, seed, bypass=True):
    """(B, P) raw vectors; with bypass slots, each stage is bypassed in one
    candidate and active in the others."""
    W = np.random.default_rng(seed).uniform(
        0.1, 0.9, (B, chain.num_params)).astype(np.float32)
    if chain.with_bypass:
        starts = [s for _, s, _ in chain.stage_slices()]
        W[:, starts] = 0.2
        if bypass:
            for i, s in enumerate(starts):
                W[(i + 1) % B, s] = 0.8
    return W


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# ------------------------------------------------------------------- ops


def test_multiband_compressor_matches_jax(monkeypatch):
    """Batched over 3 candidates with (B, 1) crossovers and (B, 1, 1) band
    parameters, as the renderer calls it, with fast=True: K8 on both sides
    (its plain version here, the Pallas kernel in interpret mode there).
    The per-candidate form (fast=False) is held by the style chain's
    per-candidate render below."""
    force_jax_tpu_plan(monkeypatch)
    fast = True
    x = _audio(0, (3, 2, 1024))
    rng = np.random.default_rng(1)

    def col(lo, hi):
        return rng.uniform(lo, hi, 3).astype(np.float32)[:, None, None]

    kw = dict(thresholds_db=[col(-40, -5) for _ in range(3)],
              ratios=[col(1, 20) for _ in range(3)],
              makeup_db=[col(-6, 6) for _ in range(3)],
              attack_ms=col(0.1, 50), release_ms=col(10, 500))
    lo = rng.uniform(100, 800, 3).astype(np.float32)[:, None]
    hi = rng.uniform(2000, 9000, 3).astype(np.float32)[:, None]

    def conv(v, f):
        return [f(u) for u in v] if isinstance(v, list) else f(v)

    got = tmb.multiband_compressor(
        torch.from_numpy(x), SR, torch.from_numpy(lo), torch.from_numpy(hi),
        fast=fast, **{k: conv(v, torch.from_numpy) for k, v in kw.items()})
    want = jmb.multiband_compressor(
        jnp.asarray(x), SR, jnp.asarray(lo), jnp.asarray(hi), fast=fast,
        **{k: conv(v, jnp.asarray) for k, v in kw.items()})
    _close(got, want)


@pytest.mark.parametrize("link", [True, False])
def test_fast_compressor_matches_jax(monkeypatch, link):
    """compressor(fast=True) on the CPU: linked, K8 on both sides; unlinked,
    K7 on both sides (its plain version here, the Pallas kernel in interpret
    mode there; on a CUDA tensor the port launches the kernel)."""
    force_jax_tpu_plan(monkeypatch)
    from st_ito_tpu.ops.pallas import scan as jax_scan
    import functools

    monkeypatch.setattr(jax_scan, "compressor_fused_pallas", functools.partial(
        jax_scan.compressor_fused_pallas, interpret=True))
    x = _audio(2, (2, 2, 1500))
    kw = dict(threshold_db=np.array([-20.0, -8.0], np.float32)[:, None, None],
              ratio=np.array([4.0, 12.0], np.float32)[:, None, None],
              attack_ms=5.0, release_ms=80.0, knee_db=3.0,
              makeup_gain_db=1.5, link_channels=link, fast=True)
    got = tdyn.compressor(torch.from_numpy(x), SR, **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    want = jdyn.compressor(jnp.asarray(x), SR, **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    _close(got, want)


def test_limiter_widener_and_gain_stages_match_jax():
    x = _audio(3, (2, 1024))
    _close(tdyn.limiter(torch.from_numpy(x), SR, -9.0, 60.0),
           jdyn.limiter(jnp.asarray(x), SR, -9.0, 60.0))
    for width in (0.0, 0.3, 1.0):
        _close(tst.stereo_widener(torch.from_numpy(x), width),
               jst.stereo_widener(jnp.asarray(x), width))
    for build in ("basic_gain", "basic_stereo_widener"):
        t, j = getattr(teffects, build)(), getattr(jeffects, build)()
        p = {q.name: q.denormalize(0.37) for q in t.params}
        _close(t.process_fn(torch.from_numpy(x),
                            {k: torch.tensor(v) for k, v in p.items()}, SR),
               j.process_fn(jnp.asarray(x), p, SR))


@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 32000),
                                   (22050, 48000)])
def test_resample_matches_jax(rates):
    x = _audio(4, (2, 4410))
    _close(resample(torch.from_numpy(x), *rates),
           jax_resample(jnp.asarray(x), *rates))


# -------------------------------------------------------------- registry


def _stage_facts(chain):
    return [(s.name, s.effect, s.num_channels, s.pad,
             [(p.name, p.min_value, p.max_value, p.default)
              for p in s.params], dict(s.fixed_parameters))
            for s in chain.stages] + [chain.with_bypass, chain.num_params]


@pytest.mark.parametrize("name", PRESETS)
def test_chain_preset_matches_jax(name):
    assert (_stage_facts(chain_preset(name))
            == _stage_facts(jeffects.chain_preset(name)))


def test_chain_from_json_matches_jax(tmp_path):
    """The repo's style chain, and a chain of VST class paths with fixed
    parameters in raw, physical and inferred units."""
    assert (_stage_facts(chain_from_json(STYLE_JSON))
            == _stage_facts(jeffects.chain_from_json(STYLE_JSON)))
    spec = {
        "EQ": {"vst_filepath": "/plugins/ZamEQ2.vst3",
               "fixed_parameters": {"band0_gain_db": 6.0}},
        "Comp": {"class_path": "st_ito.effects.BasicCompressor",
                 "fixed_parameters": {"ratio": 1.0}, "units": "physical"},
        "Max": {"vst_filepath": "ZaMaximX2.vst3", "num_channels": 1,
                "fixed_parameters": {"release_ms": 0.25}},
        "Wide": {"effect": "stereo_widener"},
        "Gain": {"effect": "gain", "fixed_parameters": {"gain_db": 0.5},
                 "units": "raw"},
    }
    path = tmp_path / "chain.json"
    path.write_text(json.dumps(spec))
    for bypass in (True, False):
        got = chain_from_json(str(path), with_bypass=bypass)
        want = jeffects.chain_from_json(str(path), with_bypass=bypass)
        assert _stage_facts(got) == _stage_facts(want)
        np.testing.assert_allclose(got.init_params().numpy(),
                                   np.asarray(want.init_params()))


# ------------------------------------------------------------- renderers


def _render_pair(monkeypatch, chain, jax_chain, B, T, fft_mode="auto",
                 seed=5):
    """Both population renderers on one population: (per-candidate max
    |port - jax|, W)."""
    force_jax_tpu_plan(monkeypatch)
    x = _audio(seed, (2, T))
    W = _population(chain, B, seed + 1)
    want = np.asarray(jax_build_batched_render_fn(
        jax_chain, SR, 2, fast=True, fft_mode=fft_mode)(
            jnp.asarray(W), jnp.asarray(x)))
    got = build_batched_render_fn(chain, SR, 2, fft_mode=fft_mode,
                                  device="cpu")(torch.from_numpy(W),
                                                torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 2, T)
    assert np.isfinite(got).all()
    return np.abs(got - want).max(axis=(1, 2)), W


def test_style_chain_render_matches_jax(monkeypatch):
    """K6 on the shared input, then K8 in the 3 bands and the limiter:
    once per render each (4 K8 calls), and no other kernel wrapper."""
    calls = []
    for name in ("biquad_cascade_plain", "ballistics_plain"):
        real = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    err, _ = _render_pair(monkeypatch, chain_from_json(STYLE_JSON),
                          jeffects.chain_from_json(STYLE_JSON), B=4, T=8192)
    assert np.all(err <= 5e-5), err
    assert sorted(calls) == ["ballistics_plain"] * 4 + [
        "biquad_cascade_plain"]


@pytest.mark.parametrize("with_bypass", [False, True])
def test_vst_chain_render_matches_jax_mega2(monkeypatch, with_bypass):
    """The CLI's vst chain (no bypass slots, as the CLI builds it; and with
    them, for K6's in-kernel blend): K6, then K3 -> K4. B = 8 so that the
    JAX gate B % 8 == 0 takes its mega2 branch; T 8192 gives n = 2^14."""
    from st_ito_torch.cli.run_optim import build_chain
    from st_ito_tpu.cli.run_optim import build_chain as jax_build_chain

    err, _ = _render_pair(
        monkeypatch, build_chain("vst", "es", with_bypass),
        jax_build_chain("vst", "es", with_bypass), B=8, T=8192,
        fft_mode="mega2")
    assert np.all(err <= 5e-5), err


@pytest.mark.parametrize("with_bypass", [False, True])
def test_compressor_chain_render_matches_jax(monkeypatch, with_bypass):
    """The single-compressor chain that st_ito_tpu/eval/psm.py:44 builds
    (and with a bypass slot, for K7's in-kernel blend): the broadcast
    input, then K7 once per render (its plain version here,
    compressor_fused_pallas interpreted there), and no other kernel
    wrapper."""
    calls = []
    for name in ("compressor_fused_plain", "biquad_cascade_plain",
                 "ballistics"):
        real = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    err, _ = _render_pair(
        monkeypatch,
        ChainSpec((teffects.EFFECT_REGISTRY["compressor"](),),
                  with_bypass=with_bypass),
        JaxChainSpec((jeffects.EFFECT_REGISTRY["compressor"](),),
                     with_bypass=with_bypass), B=4, T=4096)
    assert np.all(err <= 5e-5), err
    assert calls == ["compressor_fused_plain"]


def test_guitar_preset_render_matches_jax(monkeypatch):
    """distortion (first, on the broadcast input) -> K6 -> reverb (mx)."""
    chain = chain_preset("guitar")
    err, W = _render_pair(monkeypatch, chain, jeffects.chain_preset("guitar"),
                          B=4, T=1024, fft_mode="mx")
    dist, d_start, _ = chain.stage_slices()[0]
    drive_db = dist.params[0].denormalize(W[:, d_start + 1])
    drive = np.where(W[:, d_start] <= 0.5,
                     np.maximum(1.0, 10.0 ** (drive_db / 20.0)), 1.0)
    assert np.all(err <= 5e-5 * drive), (err, drive)


def test_mastering_preset_render_matches_jax(monkeypatch):
    """K1 (EQ -> compressor), then the limiter's K8."""
    err, _ = _render_pair(monkeypatch, chain_preset("mastering"),
                          jeffects.chain_preset("mastering"), B=4, T=1024)
    assert np.all(err <= 5e-5), err


def test_style_chain_per_candidate_render_matches_jax():
    """Every stage's process_fn, the multiband compressor and the limiter
    in their non-fast (parallel-scan) form."""
    chain = chain_from_json(STYLE_JSON)
    x = _audio(7, (2, 1024))
    w = _population(chain, 2, 8)[0]
    got = build_render_fn(chain, SR, 2, device="cpu")(w, x)
    want = jax_build_render_fn(jeffects.chain_from_json(STYLE_JSON), SR, 2)(
        jnp.asarray(w), jnp.asarray(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-5


def test_normalize_stages_fitness_matches_jax():
    """make_fitness_fn(normalize_stages=True) renders every candidate with
    the per-candidate renderer, peak-normalised after each stage, on both
    sides (the JAX package under vmap). Style chain, B = 4, the small
    Cnn14 of the embed tests in float32."""
    chain = chain_from_json(STYLE_JSON)
    params = jax_params(3, random_bn=False)
    T = 8192
    x, y = _audio(9, (2, T)), _audio(10, (1, 2, T))
    W = _population(chain, 4, 11)
    jmodel = JaxParamModel(params=params, config=JaxCnn14Config(**SMALL),
                           embed_dim=SMALL["embed_dim"])
    want = np.asarray(jax_make_fitness_fn(
        jeffects.chain_from_json(STYLE_JSON), jmodel, SR, 2,
        normalize_stages=True, compute_dtype="float32")(
            jnp.asarray(W), jnp.asarray(x),
            jax_embeds(jnp.asarray(y), jmodel, SR), None,
            jax.random.PRNGKey(0)))
    model = port_model(params)
    got = make_fitness_fn(chain, model, SR, 2, normalize_stages=True,
                          device="cpu")(
        W, x, get_param_embeds(torch.from_numpy(y), model, SR)).numpy()
    assert got.shape == want.shape == (4,) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4, (got, want)
