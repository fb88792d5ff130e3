"""st_ito_torch chain layer against st_ito_tpu: parameter codec, biquad
design, compressor helpers, EQ section stacks and the real-pair (rp)
responses that K9's plain version runs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.chain import basic_chain as jax_basic_chain
from st_ito_tpu.chain import parameters_to_dict as jax_parameters_to_dict
from st_ito_tpu.chain import rp_responses as jrp
from st_ito_tpu.chain.responses import _eq_section_stack as jax_eq_stack
from st_ito_tpu.ops import dynamics as jdyn
from st_ito_tpu.ops.iir import biquad_coeffs as jax_biquad
from st_ito_tpu.ops.iir import next_pow2 as jax_next_pow2

from st_ito_torch.chain import basic_chain, parameters_to_dict
from st_ito_torch.chain import rp_responses as trp
from st_ito_torch.chain.executor import stage_params
from st_ito_torch.chain.responses import _eq_section_stack
from st_ito_torch.ops import dynamics as tdyn
from st_ito_torch.ops.iir import biquad_coeffs, next_pow2
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
N_FFT = 4096
F = N_FFT // 2 + 1
B = 5


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_init_params_and_layout_match():
    jc, tc = jax_basic_chain(), basic_chain()
    assert tc.num_params == jc.num_params == 36
    np.testing.assert_allclose(_np(tc.init_params()), _np(jc.init_params()),
                               atol=1e-6)
    assert ([(s.name, s.effect, a, b, s.num_channels, s.pad)
             for s, a, b in tc.stage_slices()]
            == [(s.name, s.effect, a, b, s.num_channels, s.pad)
                for s, a, b in jc.stage_slices()])


def test_denormalize_and_parameters_to_dict_match():
    jc, tc = jax_basic_chain(), basic_chain()
    W = np.random.default_rng(0).random((B, tc.num_params)).astype(np.float32)
    for (ts, start, _), (js, _, _) in zip(tc.stage_slices(),
                                          jc.stage_slices()):
        got = stage_params(ts, torch.from_numpy(W), start, 1)
        for j, p in enumerate(js.params):
            want = p.denormalize(W[:, start + 1 + j])
            np.testing.assert_allclose(_np(got[p.name]), want, atol=1e-6)
    want = jax_parameters_to_dict(W[2], jc)
    got = parameters_to_dict(torch.from_numpy(W[2]), tc)
    assert got.keys() == want.keys()
    for stage in want:
        assert got[stage].keys() == want[stage].keys()
        for k in want[stage]:
            assert got[stage][k] == pytest.approx(want[stage][k], abs=1e-6)


def test_eq_section_stack_matches():
    tc = basic_chain()
    eq, start, _ = tc.stage_slices()[0]
    W = np.random.default_rng(1).random((B, tc.num_params)).astype(np.float32)
    p = stage_params(eq, torch.from_numpy(W), start, 1)
    b, a = _eq_section_stack(p, SR)
    jb, ja = jax_eq_stack({k: jnp.asarray(_np(v)) for k, v in p.items()}, SR)
    assert b.shape == (B, 6, 3)
    np.testing.assert_allclose(_np(b), _np(jb), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(a), _np(ja), rtol=1e-5, atol=1e-7)


def _params(effect, rng):
    """(B,) physical parameter values for an rp effect; the delay's
    delay_seconds * SR is fractional."""
    if effect == "delay":
        return {"delay_seconds": rng.uniform(0.01, 1.0, B) + 0.3 / SR,
                "feedback": rng.uniform(0.05, 1.0, B),
                "mix": rng.uniform(0, 1, B)}
    if effect == "reverb":
        return {k: rng.uniform(0, 1, B)
                for k in ("room_size", "damping", "wet_dry", "width")}
    if effect == "gain":
        return {"gain_db": rng.uniform(-24, 24, B)}
    return {"width": rng.uniform(0, 1, B)}


def _build_both(effect, rng):
    p = {k: v.astype(np.float32)[:, None]
         for k, v in _params(effect, rng).items()}
    ttab = trp.RP_BUNDLES[effect][0](SR, N_FFT, F)
    jtab = jrp.RP_BUNDLES[effect][0](SR, N_FFT, F)
    for k, v in jtab.items():
        if hasattr(v, "shape"):
            np.testing.assert_allclose(_np(ttab[k]), _np(v), atol=1e-5,
                                       err_msg=f"{effect} table {k}")
        else:
            assert ttab[k] == v
    tk, tH = trp.RP_BUNDLES[effect][1](
        {k: torch.from_numpy(v) for k, v in p.items()}, ttab)
    jk, jH = jrp.RP_BUNDLES[effect][1](
        {k: jnp.asarray(v) for k, v in p.items()}, jtab)
    return (tk, tH), (jk, jH)


def _assert_resp(t, j):
    (tk, tH), (jk, jH) = t, j
    assert tk == jk
    for a, b in zip(tH, jH):
        a, b = np.broadcast_arrays(_np(a), _np(b))
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("effect", ["delay", "reverb", "gain",
                                    "stereo_widener"])
def test_rp_tables_and_build_match(effect):
    t, j = _build_both(effect, np.random.default_rng(2))
    _assert_resp(t, j)


def test_rp_bypass_compose_and_packed_apply_match():
    rng = np.random.default_rng(3)
    active = (rng.random(B) > 0.4).astype(np.float32)[:, None]
    tk, tH, jk, jH = "scalar", None, "scalar", None
    for effect in ("delay", "reverb", "gain", "stereo_widener"):
        (k2, H2), (jk2, jH2) = _build_both(effect, rng)
        k2, H2 = trp.rp_bypass(k2, H2, torch.from_numpy(active))
        jk2, jH2 = jrp.rp_bypass(jk2, jH2, jnp.asarray(active))
        _assert_resp((k2, H2), (jk2, jH2))
        tk, tH = trp.rp_compose(tk, tH, k2, H2)
        jk, jH = jrp.rp_compose(jk, jH, jk2, jH2)
        _assert_resp((tk, tH), (jk, jH))
    Z = [rng.standard_normal((B, F)).astype(np.float32) for _ in range(4)]
    got = trp.rp_packed_apply(*trp.rp_packed_coeffs(tk, tH),
                              *map(torch.from_numpy, Z))
    want = jrp.rp_packed_apply(*jrp.rp_packed_coeffs(jk, jH),
                               *map(jnp.asarray, Z))
    scale = max(float(np.abs(_np(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5 * scale)


@pytest.mark.parametrize("filter_type", ["low_shelf", "peaking",
                                         "high_shelf", "lowpass", "highpass",
                                         "bandpass", "notch", "allpass"])
def test_biquad_coeffs_match(filter_type):
    rng = np.random.default_rng(4)
    g, f, q = (rng.uniform(-24, 24, B), rng.uniform(20, 18000, B),
               rng.uniform(0.1, 4.0, B))
    got = biquad_coeffs(*(torch.tensor(v, dtype=torch.float32)
                          for v in (g, f, q)), SR, filter_type)
    want = jax_biquad(*(jnp.asarray(v, jnp.float32) for v in (g, f, q)),
                      SR, filter_type)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_dynamics_helpers_and_next_pow2_match():
    rng = np.random.default_rng(5)
    ms = rng.uniform(0.1, 1000.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tdyn._time_constant_alpha(torch.from_numpy(ms), SR)),
        _np(jdyn._time_constant_alpha(jnp.asarray(ms), SR)), atol=1e-6)
    env = rng.uniform(-90, 10, 256).astype(np.float32)
    th, ratio, knee = -20.0, 4.0, 6.0
    np.testing.assert_allclose(
        _np(tdyn.gain_computer(torch.from_numpy(env), th, ratio, knee)),
        _np(jdyn.gain_computer(jnp.asarray(env), th, ratio, knee)),
        atol=1e-5)
    for n in (1, 2, 3, 4095, 4096, 262144 + 262144, 300001):
        assert next_pow2(n) == jax_next_pow2(n)
