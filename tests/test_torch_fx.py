"""The rest of the chain against st_ito_tpu: the chorus, the noise gate and
the phaser, op by op, batched, inside the population renderer and in the
whole fx chain (EQ -> noise gate -> chorus -> phaser -> gain -> widener ->
delay -> reverb), the per-candidate renderer on that chain, and the
registry's entries. The LTI response path is ``test_torch_lti_path.py``.

The JAX ops run jitted on the CPU (their associative scans take seconds
eagerly); the population renderers run op by op, the JAX one on its TPU
plan with its Pallas kernels in interpret mode (``force_jax_tpu_plan``),
but for the phaser's and the gate's scans, which are jitted
(``jit_jax_scans``; an outer jit would round the delay differently,
ROADMAP §3).
There the JAX phaser solves each allpass with ``associative_scan`` and its
gate smooths with ``ballistics_parallel``, where the port's ``fast``
renderer runs K11's and K8's plain serial loops.

Tolerances: the chorus atol 2e-5 on unit-peak input; the phaser and the
gate 1e-4 x max(1, peak), a miss decided by a float64 numpy loop (the
port no farther from it than 4x the JAX run is); the renders atol 5e-5,
rtol 1e-4 (each batched function at its op's tolerance).

Two functions are ill-conditioned in float32, and two patches hold the
rest of a render to those tolerances, each applied to both packages:

- The chorus reads its delay line at t - d, d = centre + depth_samp x
  sin(lfo phase), depth_samp up to 480 samples: a one-ulp difference
  between two sines (XLA's and torch's disagree by one ulp on about 5% of
  float32 arguments, each within 4e-8 of the true sine) moves d by up to
  3e-5 samples and flips the float32 rounding of t - d, 1e-4 x the local
  slope. ``one_sine`` gives both packages' delay modules
  float32(sin(float64)); the unpatched chorus is held to a float64 numpy
  chorus instead.
- The gate's detector is a one-pole whose coefficient (the release time's,
  10 to 1000 ms) lies within 2e-3 of 1: there the float32 serial loop and
  JAX's associative scan each lie up to 2e-4 x peak from float64, on
  opposite sides, and one ulp of the coefficient (XLA's and torch's exp
  differ by one on some arguments) is 0.3% of 1 - alpha at 1000 ms, 3e-4
  x peak in the output. ``one_detector`` gives both packages the same
  coefficients, float32(exp(float64)), and the same serial float32
  detector (K8's plain version's order of operations); the gate itself is
  held by the float64 rule above.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import effects as jeffects
from st_ito_tpu.chain import responses as jresp
from st_ito_tpu.chain.executor import (
    build_batched_render_fn as jax_build_batched_render_fn,
)
from st_ito_tpu.chain.executor import build_render_fn as jax_build_render_fn
from st_ito_tpu.ops import delay as jdelay
from st_ito_tpu.ops import dynamics as jdyn

from st_ito_torch.chain import (ChainSpec, EFFECT_REGISTRY,
                                build_batched_render_fn, build_render_fn,
                                chain_from_json)
from st_ito_torch.chain import responses as tresp
from st_ito_torch.ops import delay as tdelay
from st_ito_torch.ops import dynamics as tdyn
from st_ito_torch.ops.kernels import mega_fft, scan

from tests.test_torch_render import force_jax_tpu_plan
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
# the fx chain: EQ -> noise gate -> chorus -> phaser -> gain -> stereo
# widener -> delay -> reverb, 49 parameters with the bypass slots
FX = ("parametric_eq", "noise_gate", "chorus", "phaser", "gain",
      "stereo_widener", "delay", "reverb")


def fx_chain(names=FX, jax=False, with_bypass=True):
    registry = jeffects.EFFECT_REGISTRY if jax else EFFECT_REGISTRY
    cls = JaxChainSpec if jax else ChainSpec
    return cls(tuple(registry[n]() for n in names), with_bypass=with_bypass)


def _audio(seed, shape):
    """Noise under a slow envelope, unit peak."""
    rng = np.random.default_rng(seed)
    T = shape[-1]
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * np.arange(T) / T)
    x = rng.standard_normal(shape) * env
    return (x / np.abs(x).max()).astype(np.float32)


def _population(chain, B, seed):
    """(B, P) raw vectors; each stage bypassed in one candidate."""
    W = np.random.default_rng(seed).uniform(
        0.05, 0.95, (B, chain.num_params)).astype(np.float32)
    if chain.with_bypass:
        starts = [s for _, s, _ in chain.stage_slices()]
        W[:, starts] = 0.2
        for i, s in enumerate(starts):
            W[(i + 1) % B, s] = 0.8
    return W


def _stage_params(stage, W):
    """name -> (B,) float32 physical values of a stage without bypass."""
    return {p.name: p.denormalize(W[:, i]).astype(np.float32)
            for i, p in enumerate(stage.params)}


class _Module:
    """A module seen through, with some of its names replaced."""

    def __init__(self, module, **names):
        self._module, self._names = module, names

    def __getattr__(self, name):
        return self._names.get(name, getattr(self._module, name))


def _sin64(a):
    return np.sin(np.asarray(a, np.float64)).astype(np.float32)


def one_sine(monkeypatch):
    """Both packages' delay modules take float32(sin(float64)), the sine
    rounded once (the module docstring says why)."""
    def jsin(a):
        return jax.pure_callback(
            _sin64, jax.ShapeDtypeStruct(a.shape, jnp.float32), a,
            vmap_method="broadcast_all")

    monkeypatch.setattr(jdelay, "jnp", _Module(jnp, sin=jsin))
    monkeypatch.setattr(tdelay, "torch", _Module(
        torch, sin=lambda a: torch.sin(a.double()).float()))


def _detector_np(c, alpha_attack, alpha_release):
    """The decoupled detector in float32 numpy, in the order of operations
    of K8's plain version (``scan.ballistics_plain``)."""
    c = np.asarray(c, np.float32)
    lead = c.shape[:-1]

    def per_lane(v):
        v = np.asarray(v, np.float32)
        return np.broadcast_to(v.reshape(v.shape + (1,) * (len(lead)
                                                          - v.ndim)), lead)

    aa, ar = per_lane(alpha_attack), per_lane(alpha_release)
    y1 = np.zeros(lead, np.float32)
    g = np.zeros(lead, np.float32)
    out = np.empty_like(c)
    for n in range(c.shape[-1]):
        ct = c[..., n]
        y1 = np.minimum(ct, ar * y1 + (np.float32(1.0) - ar) * ct)
        g = aa * g + (np.float32(1.0) - aa) * y1
        out[..., n] = g
    return out


def one_detector(monkeypatch):
    """Both packages' gates take the same time constants and smooth with
    the same serial float32 detector: JAX's ``ballistics_parallel`` and the
    port's become ``_detector_np`` (the port's fast gate runs K8's plain
    version, the same arithmetic), and their ``_time_constant_alpha``
    float32(exp(float64))."""
    def jdet(c, aa, ar):
        return jax.pure_callback(
            _detector_np, jax.ShapeDtypeStruct(c.shape, jnp.float32), c,
            jnp.asarray(aa, jnp.float32), jnp.asarray(ar, jnp.float32),
            vmap_method="broadcast_all")

    def tdet(c, aa, ar):
        return torch.from_numpy(_detector_np(c.numpy(), aa, ar))

    def alpha64(time_ms, sample_rate):
        t = np.maximum(np.asarray(time_ms, np.float64), 1e-3)
        return np.exp(-1.0 / (t * 0.001 * sample_rate)).astype(np.float32)

    def jalpha(time_ms, sample_rate):
        time_ms = jnp.asarray(time_ms, jnp.float32)
        return jax.pure_callback(
            lambda t: alpha64(t, sample_rate),
            jax.ShapeDtypeStruct(time_ms.shape, jnp.float32), time_ms,
            vmap_method="broadcast_all")

    def talpha(time_ms, sample_rate):
        return torch.as_tensor(np.asarray(alpha64(
            torch.as_tensor(time_ms).numpy(), sample_rate)))

    monkeypatch.setattr(jdyn, "ballistics_parallel", jdet)
    monkeypatch.setattr(tdyn, "ballistics_parallel", tdet)
    monkeypatch.setattr(jdyn, "_time_constant_alpha", jalpha)
    monkeypatch.setattr(tdyn, "_time_constant_alpha", talpha)


def jit_jax_scans(monkeypatch):
    """The JAX phaser's allpass scans and the gate's detector, jitted."""
    monkeypatch.setattr(jdelay, "linear_recurrence",
                        jax.jit(jdelay.linear_recurrence))
    monkeypatch.setattr(jdyn, "ballistics_parallel",
                        jax.jit(jdyn.ballistics_parallel))


def _peak_tol(want):
    return 1e-4 * max(1.0, float(np.abs(want).max()))


# ------------------------------------------------------------ registry


@pytest.mark.parametrize("effect", sorted(jeffects.EFFECT_REGISTRY))
def test_registry_entry_matches_jax(tmp_path, effect):
    """Every effect builds with the JAX package's stage name, parameter
    names, ranges, defaults, channels and pad; it has a response function
    exactly where the JAX stage has one; and a JSON chain of it loads."""
    import json

    def facts(s):
        return (s.name, s.effect, s.num_channels, s.pad,
                [(p.name, p.min_value, p.max_value, p.default)
                 for p in s.params], s.response_fn is None)

    assert facts(EFFECT_REGISTRY[effect]()) == facts(
        jeffects.EFFECT_REGISTRY[effect]())
    path = tmp_path / "chain.json"
    path.write_text(json.dumps({"X": {"effect": effect}}))
    assert chain_from_json(str(path)).stages[0].effect == effect


# ------------------------------------------------------------------ ops


def _batched_case(effect, B, T, seed):
    stage = EFFECT_REGISTRY[effect]()
    W = np.random.default_rng(seed).uniform(
        0.0, 1.0, (B, len(stage.params))).astype(np.float32)
    return _audio(seed + 1, (B, 2, T)), _stage_params(stage, W)


def _both_batched(effect, x, p, fast):
    jfn = getattr(jresp, f"{effect}_batched")
    if effect != "chorus":  # the chorus is cheap op by op, and exact there
        jfn = jax.jit(jfn, static_argnums=(2, 3))
    tfn = getattr(tresp, f"{effect}_batched")
    want = np.asarray(jfn(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, SR,
                          fast))
    got = tfn(torch.from_numpy(x), {k: torch.from_numpy(v)
                                    for k, v in p.items()}, SR, fast).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return got, want


def test_chorus_matches_jax(monkeypatch):
    """4 candidates batched by broadcasting (one gather index row each)
    against the JAX package's vmap, and one candidate's ``chorus`` alone,
    both taking the same sine: atol 2e-5 on unit-peak input."""
    one_sine(monkeypatch)
    x, p = _batched_case("chorus", 4, 8192, 0)
    got, want = _both_batched("chorus", x, p, True)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    args = [p[k][1] for k in ("rate_hz", "centre_delay_ms", "depth",
                              "feedback", "mix")]
    want = np.asarray(jdelay.chorus(jnp.asarray(x[1]), SR, *args))
    got = tdelay.chorus(torch.from_numpy(x[1]), SR, *args).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _chorus64(x, rate, centre_ms, depth, feedback, mix):
    """The chorus of one candidate in float64 numpy."""
    T = x.shape[-1]
    t = np.arange(T, dtype=np.float64)
    centre = centre_ms * 1e-3 * SR
    d = np.maximum(centre + depth * 0.5 * centre
                   * np.sin(2.0 * math.pi * rate * t / SR), 1.0)
    pos = np.clip(t - d, 0.0, T - 1.0)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, T - 1)
    frac = pos - i0

    def frac_delay(s):
        return ((1.0 - frac) * s[..., i0] + frac * s[..., i1]) * (t >= d)

    wet = frac_delay(x.astype(np.float64))
    acc = wet
    for _ in range(4):
        wet = frac_delay(wet) * feedback * 0.95
        acc = acc + wet
    return (1.0 - mix) * x + mix * acc


def test_chorus_float64_witness():
    """Each package with its own sine: the port's chorus no farther from a
    float64 numpy chorus than 4x the JAX chorus is, on each candidate."""
    x, p = _batched_case("chorus", 4, 8192, 0)
    got, want = _both_batched("chorus", x, p, True)
    for b in range(4):
        ref = _chorus64(x[b], *(float(p[k][b]) for k in (
            "rate_hz", "centre_delay_ms", "depth", "feedback", "mix")))
        e_port = np.abs(got[b] - ref).max()
        e_jax = np.abs(want[b] - ref).max()
        assert e_port <= 4.0 * e_jax + 1e-6, (b, e_port, e_jax)


def _phaser64(x, rate, depth, centre, feedback, mix):
    """The phaser of one candidate in float64 numpy, each allpass a loop."""
    T = x.shape[-1]
    t = np.arange(T, dtype=np.float64)
    lfo = 0.5 * (1.0 + np.sin(2.0 * math.pi * rate * t / SR))
    f = np.clip(centre * 2.0 ** (depth * (2.0 * lfo - 1.0)), 20.0, 0.49 * SR)
    th = np.tan(math.pi * f / SR)
    a = (th - 1.0) / (th + 1.0)
    wet = x.astype(np.float64)
    for _ in range(6):
        y = np.zeros_like(wet)
        prev_y = np.zeros(wet.shape[:-1])
        for n in range(T):
            drive = a[n] * wet[..., n] + (wet[..., n - 1] if n else 0.0)
            prev_y = (-a[n - 1] if n else 0.0) * prev_y + drive
            y[..., n] = prev_y
        wet = y
    wet = wet + feedback * x
    return (1.0 - mix) * x + mix * 0.5 * (x + wet)


@pytest.mark.parametrize("fast", [True, False], ids=["k11", "doubling"])
def test_phaser_matches_jax(fast):
    """K11's plain serial loop (``fast``) and the doubling scan against
    JAX's ``associative_scan``: 1e-4 x max(1, peak); on a miss the float64
    loop decides (the port no farther from it than 4x JAX is). With
    ``fast`` each of the 6 allpasses is one K11 call."""
    x, p = _batched_case("phaser", 4, 4096, 2)
    before = scan.launches["linear_recurrence"]
    calls = []
    real = scan.linear_recurrence_plain
    scan.linear_recurrence_plain = lambda *a: (calls.append(1), real(*a))[1]
    try:
        got, want = _both_batched("phaser", x, p, fast)
    finally:
        scan.linear_recurrence_plain = real
    assert len(calls) == (6 if fast else 0)
    assert scan.launches["linear_recurrence"] == before  # no card here
    keys = ("rate_hz", "depth", "centre_frequency_hz", "feedback", "mix")
    for b in range(4):
        _hold_or_witness(got[b], want[b], lambda: _phaser64(
            x[b], *(float(p[k][b]) for k in keys)))


@pytest.mark.parametrize("fast", [True, False], ids=["k8", "parallel"])
def test_noise_gate_matches_jax(fast):
    """The gate's detector in K8's plain serial loop (``fast``) or the
    parallel form against JAX's ``ballistics_parallel``, with the release
    and attack coefficients in the swapped slots: the gate output within
    1e-4 x max(1, peak). Thresholds reach from -100 to 0 dB, so some
    candidates are gated hard and some not at all; with ``fast`` one K8
    call on the 4 candidates' envelopes."""
    x, p = _batched_case("noise_gate", 4, 4096, 4)
    x[:, :, 1000:1400] *= 1e-3  # a quiet stretch the gate closes on
    calls = []
    real = scan.ballistics_plain
    scan.ballistics_plain = lambda *a: (calls.append(a[0].shape), real(*a))[1]
    try:
        got, want = _both_batched("noise_gate", x, p, fast)
    finally:
        scan.ballistics_plain = real
    assert calls == ([(4, 4096)] if fast else [])
    keys = ("threshold_db", "ratio", "attack_ms", "release_ms")
    for b in range(4):
        args = [float(p[k][b]) for k in keys]
        _hold_or_witness(got[b], want[b], lambda: _gate64(x[b], *args))
    # one candidate through noise_gate itself, scalar parameters
    args = [float(p[k][0]) for k in keys]
    want = np.asarray(jax.jit(lambda v: jdyn.noise_gate(v, SR, *args))(
        jnp.asarray(x[0])))
    got = tdyn.noise_gate(torch.from_numpy(x[0]), SR, *args).numpy()
    _hold_or_witness(got, want, lambda: _gate64(x[0], *args))


def _hold_or_witness(got, want, ref64):
    """1e-4 x max(1, peak), or on a miss no farther from the float64 run
    ``ref64()`` than 4x the JAX run is."""
    if np.abs(got - want).max() <= _peak_tol(want):
        return
    ref = ref64()
    assert np.abs(got - ref).max() <= 4.0 * np.abs(want - ref).max()


def _gate64(x, threshold_db, ratio, attack_ms, release_ms):
    """The noise gate of one candidate in float64 numpy, its detector a
    loop (the release coefficient in the attack slot, as JAX has it)."""
    env = np.abs(x.astype(np.float64)).max(axis=0)
    env_db = 20.0 * np.log10(np.maximum(env, 1e-8))
    c = np.maximum(np.minimum(env_db - threshold_db, 0.0) * (ratio - 1.0),
                   -100.0)
    a_open = math.exp(-1.0 / (release_ms * 1e-3 * SR))
    a_close = math.exp(-1.0 / (attack_ms * 1e-3 * SR))
    y1 = g = 0.0
    out = np.empty_like(c)
    for n, cn in enumerate(c):
        y1 = min(cn, a_close * y1 + (1.0 - a_close) * cn)
        g = a_open * g + (1.0 - a_open) * y1
        out[n] = g
    return x * 10.0 ** (out / 20.0)


# ----------------------------------------------------- population renders


def _render_pair(monkeypatch, names, B, T, fft_mode="mega2", seed=5,
                 with_bypass=True, mono=False, **kw):
    """Both population renderers on one population of the chain ``names``:
    (port (B, C, T), JAX (B, C, T)), the JAX one op by op on its TPU
    plan."""
    force_jax_tpu_plan(monkeypatch)
    jit_jax_scans(monkeypatch)
    x = _audio(seed, (1 if mono else 2, T))
    chain = fx_chain(names, with_bypass=with_bypass)
    W = _population(chain, B, seed + 1)
    want = np.asarray(jax_build_batched_render_fn(
        fx_chain(names, jax=True, with_bypass=with_bypass), SR, x.shape[0],
        fast=True, fft_mode=fft_mode, **kw)(jnp.asarray(W), jnp.asarray(x)))
    got = build_batched_render_fn(chain, SR, x.shape[0], fft_mode=fft_mode,
                                  device="cpu", **kw)(
        torch.from_numpy(W), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return got, want


@pytest.mark.parametrize("effect,tol,kernel,calls", [
    ("noise_gate", 1e-4, "ballistics_plain", 1),
    ("chorus", 2e-5, None, 0),
    ("phaser", 1e-4, "linear_recurrence_plain", 6)])
def test_batched_fn_inside_the_renderer(monkeypatch, effect, tol, kernel,
                                        calls):
    """Each of the three batched functions as the population renderer runs
    it, on the broadcast input with the bypass slot (the dry signal where
    a candidate bypasses it), peak-normalised: its kernel's plain version
    called ``calls`` times a render, and each op's tolerance (one sine,
    one detector)."""
    one_sine(monkeypatch)
    one_detector(monkeypatch)
    seen = []
    for name in ("ballistics_plain", "linear_recurrence_plain"):
        real = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _r=real, _n=name: (
            seen.append(_n), _r(*a))[1])
    got, want = _render_pair(monkeypatch, (effect,), B=4, T=2048,
                             fft_mode="auto")
    assert seen == [kernel] * calls
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_gate_render_float64_witness(monkeypatch):
    """The gate as the renderer runs it, each package with its own
    detector: each candidate within 1e-4 of JAX's, or no farther from a
    float64 gate (peak-normalised; the dry input where bypassed) than 4x
    JAX's render is."""
    got, want = _render_pair(monkeypatch, ("noise_gate",), B=4, T=2048,
                             fft_mode="auto")
    chain = fx_chain(("noise_gate",))
    stage, start, _ = chain.stage_slices()[0]
    x = _audio(5, (2, 2048))
    W = _population(chain, 4, 6)
    p = _stage_params(stage, W[:, start + 1:])
    for b in range(4):
        def ref64(b=b):
            y = (_gate64(x, *(float(p[k][b]) for k in (
                "threshold_db", "ratio", "attack_ms", "release_ms")))
                 if W[b, start] <= 0.5 else x.astype(np.float64))
            return y / max(np.abs(y).max(), 1e-8)

        _hold_or_witness(got[b], want[b], ref64)


def test_fx_chain_render_matches_jax_mega2(monkeypatch):
    """The whole fx chain (49 parameters): K6 on the shared input, the
    gate's K8, the chorus, the phaser's 6 K11 calls, then gain -> widener
    -> delay -> reverb as one group in K3 -> K4; B = 8 so that the JAX gate
    B % 8 == 0 takes its mega2 branch, T 8192 (n 2^14). atol 5e-5,
    rtol 1e-4 after peak normalisation (one sine, one detector)."""
    one_sine(monkeypatch)
    one_detector(monkeypatch)
    seen = []
    for mod, name in ((scan, "biquad_cascade_plain"),
                      (scan, "ballistics_plain"),
                      (scan, "linear_recurrence_plain"),
                      (mega_fft, "fwd_pack_fft_response_plain"),
                      (mega_fft, "inv_unpack_fft_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            seen.append(_n), _r(*a))[1])
    got, want = _render_pair(monkeypatch, FX, B=8, T=8192)
    assert fx_chain().num_params == 49
    assert sorted(seen) == sorted(
        ["biquad_cascade_plain", "ballistics_plain",
         "fwd_pack_fft_response_plain", "inv_unpack_fft_plain"]
        + ["linear_recurrence_plain"] * 6)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_fx_chain_per_candidate_render_matches_jax(monkeypatch):
    """``build_render_fn`` on the fx chain: every stage's ``process_fn``
    (the gate and the phaser in their parallel forms); 5e-5 after peak
    normalisation (one sine, one detector)."""
    jit_jax_scans(monkeypatch)
    one_sine(monkeypatch)
    one_detector(monkeypatch)
    chain = fx_chain()
    x = _audio(11, (2, 1024))
    w = _population(chain, 2, 12)[0]
    want = np.asarray(jax_build_render_fn(fx_chain(jax=True), SR, 2)(
        jnp.asarray(w), jnp.asarray(x)))
    got = build_render_fn(chain, SR, 2, device="cpu")(
        torch.from_numpy(w), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phaser_k11_and_gate_k8_on_the_card(cuda_device, monkeypatch):
    """The phaser's allpasses on K11 and the gate's detector on K8, on the
    card, against the same functions with the kernels' plain versions: one
    K11 launch per allpass, each held on the (coeff, drive) it was given by
    K11's two rules, and the phaser within 1e-4 x max(1, peak); one K8
    launch per gate, held on the detector input it was given by K8's. The
    rules (``chunked.gate_excess``), as the chunked scans are held: the
    first chunk bitwise, (b) on every lane, (a) wherever the float32 plain
    run lies within 1e-4 x peak of float64."""
    from st_ito_torch.ops.kernels import chunked

    def hold(out, want32, want64, L):
        assert torch.equal(out[:, :L], want32[:, :L])
        excess = chunked.gate_excess(out, want32, want64=want64)
        assert excess["b"] <= 0.0 and excess["a_miss_plain_near"] == 0, excess

    x, p = _batched_case("phaser", 37, 20011, 21)
    want = tresp.phaser_batched(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in p.items()}, SR, True).numpy()
    seen = []
    real_k11 = scan.linear_recurrence_cuda
    monkeypatch.setattr(scan, "linear_recurrence_cuda", lambda a_in, b_in: (
        seen.append((a_in, b_in, real_k11(a_in, b_in))), seen[-1][2])[1])
    before = scan.launches["linear_recurrence"]
    got = tresp.phaser_batched(torch.from_numpy(x).to(cuda_device), {
        k: torch.from_numpy(v).to(cuda_device) for k, v in p.items()}, SR,
        True)
    torch.cuda.synchronize()
    assert scan.launches["linear_recurrence"] == before + 6
    assert len(seen) == 6
    L = scan.linrec_chunk_len(74, 20011)
    for a_in, b_in, out in ((v.cpu() for v in call) for call in seen):
        assert a_in.shape == (74, 20011)
        hold(out, scan.linear_recurrence_plain(a_in, b_in),
             scan.linear_recurrence_plain(a_in, b_in, dtype=torch.float64), L)
    assert np.abs(got.cpu().numpy() - want).max() <= _peak_tol(want)

    x, p = _batched_case("noise_gate", 37, 20011, 22)
    seen = []
    real = scan.ballistics_cuda
    monkeypatch.setattr(scan, "ballistics_cuda", lambda c_in, vec: (
        seen.append((c_in, vec, real(c_in, vec))), seen[-1][2])[1])
    before = scan.launches["ballistics"]
    tresp.noise_gate_batched(torch.from_numpy(x).to(cuda_device), {
        k: torch.from_numpy(v).to(cuda_device) for k, v in p.items()}, SR,
        True)
    torch.cuda.synchronize()
    assert scan.launches["ballistics"] == before + 1 and len(seen) == 1
    c_in, vec, out = (v.cpu() for v in seen[0])
    assert c_in.shape == (37, 20011) and float(c_in.min()) >= -100.0
    want32 = scan.ballistics_plain(c_in, vec)
    want64 = scan.ballistics_plain(c_in, vec, dtype=torch.float64)
    hold(out, want32, want64, scan.detector_chunk_len(37, 20011))
