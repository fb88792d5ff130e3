"""The per-stage LTI response path against st_ito_tpu: each LTI stage's
response (``chain/responses.py``), the bypass blend, the composition and
the application, the population renderer with ``fft_mode="xla"``, with
``fuse_lti=False`` and on a mono LTI group; and the rest of item 7's
small ops: the exact per-sample filters (``biquad_scan``, ``lfilter_scan``,
``parametric_eq_scan``) against scipy and the native C++ engine,
``one_pole_smooth`` and the stereo and waveshape helpers.

The population renderers run op by op, the JAX one on its TPU plan with
its Pallas kernels in interpret mode (``force_jax_tpu_plan``, through
``test_torch_fx._render_pair``). Tolerances: the renders atol 5e-5, rtol
1e-4; one response or op atol 2e-5, rtol 1e-4."""

import math

import numpy as np
import pytest
import scipy.signal
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import effects as jeffects
from st_ito_tpu.chain import responses as jresp
from st_ito_tpu.ops import eq as jeq
from st_ito_tpu.ops import iir as jiir
from st_ito_tpu.ops import stereo as jst
from st_ito_tpu.ops import waveshape as jws

from st_ito_torch.chain import EFFECT_REGISTRY, build_batched_render_fn
from st_ito_torch.chain import build_render_fn
from st_ito_torch.chain import responses as tresp
from st_ito_torch.ops import eq as teq
from st_ito_torch.ops import iir as tiir
from st_ito_torch.ops import stereo as tst
from st_ito_torch.ops import waveshape as tws

from tests.test_torch_fx import (SR, _audio, _population, _render_pair,
                                 _stage_params, fx_chain)

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("names", [
    ("parametric_eq", "compressor", "gain", "stereo_widener", "delay",
     "reverb"),
    ("stereo_widener", "reverb", "gain"),
], ids=["eqcomp_then_group", "group_first"])
def test_xla_render_matches_jax(monkeypatch, names):
    """``fft_mode="xla"``: the group's per-stage responses composed
    (scalar and monomix) and applied between rfft and irfft, the EQ still
    on K1 (behind it the compressor) as in the TPU plan; or the group
    first, on the broadcast input. atol 5e-5, rtol 1e-4."""
    got, want = _render_pair(monkeypatch, names, B=4, T=1024, fft_mode="xla")
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("fft_mode,T", [("mega2", 8192), ("xla", 2048)],
                         ids=["mega2", "xla"])
def test_unfused_lti_render_matches_jax(monkeypatch, fft_mode, T):
    """``fuse_lti=False``: each LTI stage its own group, truncated to the
    buffer, through the same dispatch (gain -> widener -> delay -> reverb
    behind the EQ); B = 8 for the JAX mega gate, T 8192 so that the delay's
    and the reverb's groups (n 2^14) take K3 -> K4 in mega2 (the gain's and
    the widener's, n 2^13, take the mx path, in both packages). atol 5e-5,
    rtol 1e-4."""
    names = ("parametric_eq", "gain", "stereo_widener", "delay", "reverb")
    got, want = _render_pair(monkeypatch, names, B=8, T=T,
                             fft_mode=fft_mode, fuse_lti=False)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_unfused_lti_render_is_the_per_candidate_render():
    """Truncating at every stage boundary is the per-candidate renderer's
    semantics: ``fuse_lti=False`` in "xla" equals ``build_render_fn`` on
    every candidate (5e-5)."""
    names = ("gain", "stereo_widener", "delay", "reverb")
    chain = fx_chain(names)
    x = torch.from_numpy(_audio(9, (2, 2048)))
    W = torch.from_numpy(_population(chain, 3, 10))
    got = build_batched_render_fn(chain, SR, 2, fft_mode="xla",
                                  fuse_lti=False, device="cpu")(W, x)
    render = build_render_fn(chain, SR, 2, device="cpu")
    want = torch.stack([render(w, x) for w in W])
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("fft_mode", ["mega2", "mx"])
def test_mono_lti_group_matches_jax(monkeypatch, fft_mode):
    """A mono input through EQ -> gain: K6, then a mono LTI group, which
    takes the per-stage response path in every mode (the rp kernels are
    stereo-only). atol 5e-5, rtol 1e-4."""
    got, want = _render_pair(monkeypatch, ("parametric_eq", "gain"), B=8,
                             T=2048, fft_mode=fft_mode, mono=True)
    assert got.shape == (8, 1, 2048)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


# ------------------------------------------------------ response algebra


@pytest.mark.parametrize("effect", ["parametric_eq", "delay", "gain",
                                    "stereo_widener", "reverb"])
def test_stage_response_matches_jax(effect):
    """Each LTI stage's response on the 2^13 rfft grid for 3 candidates
    (stereo; the reverb mono too), bypass-blended (one candidate
    bypassed), composed after the delay's and applied to a spectrum: atol
    2e-5, rtol 1e-4 of each array."""
    n = 8192
    F = n // 2 + 1
    omega_np = np.linspace(0.0, math.pi, F, dtype=np.float32)
    omega = torch.linspace(0.0, math.pi, F, dtype=torch.float32)
    stage = EFFECT_REGISTRY[effect]()
    jstage = jeffects.EFFECT_REGISTRY[effect]()
    rng = np.random.default_rng(13)
    W = rng.uniform(0.05, 0.95, (3, len(stage.params))).astype(np.float32)
    p = _stage_params(stage, W)
    active = np.array([True, False, True])
    delay = EFFECT_REGISTRY["delay"]()
    pd = _stage_params(delay, rng.uniform(0.05, 0.95, (3, 3)).astype(
        np.float32))
    X = (rng.standard_normal((3, 2, F))
         + 1j * rng.standard_normal((3, 2, F))).astype(np.complex64)

    def close(a, b):
        a = [a] if isinstance(a, torch.Tensor) else list(a)
        b = [b] if not isinstance(b, tuple) else list(b)
        for u, v in zip(a, b):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=2e-5,
                                       rtol=1e-4)

    for channels in ((2, 1) if effect == "reverb" else (2,)):
        tk, tH = stage.response_fn({k: torch.from_numpy(v)
                                    for k, v in p.items()}, omega, SR,
                                   channels)
        jk, jH = jstage.response_fn({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(omega_np), SR, channels)
        assert tk == jk
        close(tH, jH)
        tH = tresp.bypass_blend(tk, tH, torch.from_numpy(active))
        jH = jresp.bypass_blend(jk, jH, jnp.asarray(active))
        close(tH, jH)
        tdk, tdH = tresp.delay_response(
            {k: torch.from_numpy(v) for k, v in pd.items()}, omega, SR, 2)
        jdk, jdH = jresp.delay_response(
            {k: jnp.asarray(v) for k, v in pd.items()}, jnp.asarray(omega_np),
            SR, 2)
        tk, tH = tresp.compose_responses(tdk, tdH, tk, tH, F)
        jk, jH = jresp.compose_responses(jdk, jdH, jk, jH, F)
        assert tk == jk
        close(tH, jH)
        if channels == 2:
            close(tresp.apply_response(tk, tH, torch.from_numpy(X)),
                  jresp.apply_response(jk, jH, jnp.asarray(X)))


def test_matrix_responses_match_jax():
    """The generic (B, 2, 2, F) form: a monomix composed with a matrix,
    and its application."""
    rng = np.random.default_rng(14)
    F = 33

    def c(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    M, mono, X = c(2, 2, 2, F), tuple(c(2, F) for _ in range(3)), c(2, 2, F)
    tk, tH = tresp.compose_responses(
        "monomix", tuple(torch.from_numpy(v) for v in mono), "matrix",
        torch.from_numpy(M), F)
    jk, jH = jresp.compose_responses(
        "monomix", tuple(jnp.asarray(v) for v in mono), "matrix",
        jnp.asarray(M), F)
    assert tk == jk == "matrix"
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(
        tresp.apply_response(tk, tH, torch.from_numpy(X)).numpy(),
        np.asarray(jresp.apply_response(jk, jH, jnp.asarray(X))), atol=2e-5,
        rtol=1e-4)
    act = np.array([False, True])
    np.testing.assert_allclose(
        tresp.bypass_blend("matrix", tH, torch.from_numpy(act)).numpy(),
        np.asarray(jresp.bypass_blend("matrix", jH, jnp.asarray(act))),
        atol=2e-5, rtol=1e-4)


# -------------------------------------------- exact filters, small ops


def test_biquad_and_lfilter_scans_match_scipy():
    """``biquad_scan`` on a peaking section and ``lfilter_scan`` on a
    fourth-order filter (two sections multiplied out): run in float64
    against scipy's lfilter (atol 1e-9: the same recurrence), and in
    float32 against the JAX scans (``_float32_rule``: the direct-form
    fourth-order filter in float32 lies 3e-3 from float64, in either
    package)."""
    x = _audio(15, (2, 4096))
    b, a = (v.numpy() for v in tiir.biquad_coeffs(6.0, 1000.0, 2.0, SR,
                                                  "peaking"))
    b2, a2 = (v.numpy() for v in tiir.biquad_coeffs(0.0, 200.0, 0.7, SR,
                                                    "highpass"))
    b4 = np.convolve(b, b2).astype(np.float32)
    a4 = np.convolve(a, a2).astype(np.float32)
    for fn, jfn, bb, aa in ((tiir.biquad_scan, jiir.biquad_scan, b, a),
                            (tiir.lfilter_scan, jiir.lfilter_scan, b4, a4)):
        got64 = fn(torch.from_numpy(x.astype(np.float64)),
                   torch.from_numpy(bb.astype(np.float64)),
                   torch.from_numpy(aa.astype(np.float64))).numpy()
        ref = scipy.signal.lfilter(bb.astype(np.float64),
                                   aa.astype(np.float64), x)
        np.testing.assert_allclose(got64, ref, atol=1e-9)
        got = fn(torch.from_numpy(x), torch.from_numpy(bb),
                 torch.from_numpy(aa)).numpy()
        want = np.asarray(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(bb),
                                       jnp.asarray(aa)))
        _float32_rule(got, want, ref)


def _float32_rule(got, want, ref64):
    """A float32 scan against JAX's (whose lax.scan body XLA contracts
    into FMAs): within 2e-5 x max(1, peak), or no farther from the float64
    run ``ref64`` than 4x the JAX run is."""
    if np.abs(got - want).max() <= 2e-5 * max(1.0, np.abs(want).max()):
        return
    assert np.abs(got - ref64).max() <= 4.0 * np.abs(want - ref64).max()


EQ_KW = dict(low_shelf_gain_db=-6.0, low_shelf_cutoff_freq=120.0,
             low_shelf_q_factor=0.707, band_gains_db=[4.0, -3.0, 6.0, -2.0],
             band_cutoff_freqs=[300.0, 1000.0, 3000.0, 8000.0],
             band_q_factors=[0.7, 1.5, 2.0, 0.9], high_shelf_gain_db=5.0,
             high_shelf_cutoff_freq=6000.0, high_shelf_q_factor=0.707)


def test_parametric_eq_scan_matches_scipy_and_jax():
    """The exact cascade: in float64 against scipy's sosfilt (atol 1e-9),
    in float32 against the JAX scan (``_float32_rule``)."""
    x = _audio(16, (2, 4096))
    sos_args = [torch.as_tensor(EQ_KW[k], dtype=torch.float64) for k in (
        "low_shelf_gain_db", "low_shelf_cutoff_freq", "low_shelf_q_factor",
        "band_gains_db", "band_cutoff_freqs", "band_q_factors",
        "high_shelf_gain_db", "high_shelf_cutoff_freq",
        "high_shelf_q_factor")]
    b, a = (v.numpy().astype(np.float64)
            for v in teq.parametric_eq_sos(SR, *sos_args))
    got64 = teq.parametric_eq_scan(torch.from_numpy(x.astype(np.float64)),
                                   SR, **EQ_KW).numpy()
    ref = scipy.signal.sosfilt(np.concatenate([b, a], -1), x)
    np.testing.assert_allclose(got64, ref, atol=1e-9)
    got = teq.parametric_eq_scan(torch.from_numpy(x), SR, **EQ_KW).numpy()
    want = np.asarray(jax.jit(lambda v: jeq.parametric_eq_scan(
        v, SR, **EQ_KW))(jnp.asarray(x)))
    _float32_rule(got, want, ref)


def test_parametric_eq_scan_matches_the_native_engine():
    """The basic EQ stage at one setting through ``csrc/libstito_dsp.so``
    (the JAX package's ctypes binding, as tests/test_native.py drives it)
    and through ``parametric_eq_scan``: both exact time-domain cascades,
    atol 1e-4."""
    from st_ito_tpu.chain import ChainSpec as JChain
    from st_ito_tpu.chain import basic_parametric_eq
    from st_ito_tpu.native import native_available, native_render

    if not native_available():
        pytest.skip("the native engine needs g++")
    chain = JChain(stages=(basic_parametric_eq(),), with_bypass=False)
    x = _audio(17, (1, 8192)) * 0.3
    w = np.random.default_rng(18).uniform(0.3, 0.7, chain.num_params).astype(
        np.float32)
    want = native_render(chain, w, x, SR, normalize_output=False)
    stage = chain.stages[0]
    p = {q.name: float(q.denormalize(w[i])) for i, q in
         enumerate(stage.params)}
    kw = {k: v for k, v in p.items() if not k.startswith("band")}
    for key, arg in (("gain_db", "band_gains_db"),
                     ("cutoff_freq", "band_cutoff_freqs"),
                     ("q_factor", "band_q_factors")):
        kw[arg] = [p[f"band{i}_{key}"] for i in range(4)]
    got = teq.parametric_eq_scan(torch.from_numpy(x), SR, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_small_ops_match_jax():
    """``one_pole_smooth`` (a time-varying alpha), ``flip_phase``,
    ``fade_in``, ``peak_normalize``, ``pan``, ``mono_to_stereo`` and
    ``swap_channels``: atol 2e-5, rtol 1e-4."""
    x = _audio(19, (3, 2, 512))
    alpha = np.random.default_rng(20).uniform(0.5, 0.999, (3, 2, 512)
                                              ).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (tiir.one_pole_smooth(tx, torch.from_numpy(alpha)),
         jax.jit(jiir.one_pole_smooth)(jx, jnp.asarray(alpha))),
        (tiir.one_pole_smooth(tx, 0.9),
         jax.jit(jiir.one_pole_smooth)(jx, 0.9)),
        (tws.flip_phase(tx), jws.flip_phase(jx)),
        (tws.fade_in(tx, 300), jws.fade_in(jx, 300)),
        (tws.peak_normalize(tx * 3.0), jws.peak_normalize(jx * 3.0)),
        (tst.pan(tx, 0.3), jst.pan(jx, 0.3)),
        (tst.mono_to_stereo(tx[:, :1]), jst.mono_to_stereo(jx[:, :1])),
        (tst.swap_channels(tx), jst.swap_channels(jx)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-4)
