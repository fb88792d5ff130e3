"""The per-candidate renderer and the ops under it: each plain-PyTorch op of
st_ito_torch against the st_ito_tpu function on the same numpy inputs, each
of the five basic stages' ``process_fn``, and ``build_render_fn`` as a
whole. Everything here is float32 FFT and elementwise math on both sides
(no Pallas kernel is reached), run op by op (no jit), on O(1) signals.

Tolerances: atol 2e-5, rtol 1e-4 for one op or stage (the JAX package's own
kernel-parity class, ``tests/test_dynamics.py:149``); the whole chain gets
5e-5 after peak normalisation, times the distortion's drive where it is on
(tanh(drive * y) multiplies the rounding of y by up to the drive), as the
population renderer's test does."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.chain import basic_chain as jax_basic_chain
from st_ito_tpu.chain.executor import build_render_fn as jax_build_render_fn
from st_ito_tpu.ops import delay as jdelay
from st_ito_tpu.ops import dynamics as jdyn
from st_ito_tpu.ops import eq as jeq
from st_ito_tpu.ops import iir as jiir
from st_ito_tpu.ops import reverb as jrev
from st_ito_tpu.ops import waveshape as jws

from st_ito_torch.chain import basic_chain, build_render_fn
from st_ito_torch.ops import delay as tdelay
from st_ito_torch.ops import dynamics as tdyn
from st_ito_torch.ops import eq as teq
from st_ito_torch.ops import iir as tiir
from st_ito_torch.ops import reverb as trev
from st_ito_torch.ops import waveshape as tws
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 4096
ATOL, RTOL = 2e-5, 1e-4


def _audio(seed, C=2, T_=T):
    """(C, T) noise under a slow envelope, peak 0.9: the compressor sees
    both sides of its threshold."""
    rng = np.random.default_rng(seed)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * np.arange(T_) / T_)
    x = rng.standard_normal((C, T_)) * env
    return (0.9 * x / np.abs(x).max()).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _t(v):
    return torch.as_tensor(np.asarray(v, np.float32))


# ------------------------------------------------------------------- ops


def test_gain_and_distortion_match_jax():
    x = _audio(0)
    _close(tws.gain(_t(x), -7.5), jws.gain(jnp.asarray(x), -7.5))
    _close(tws.distortion(_t(x), 18.0), jws.distortion(jnp.asarray(x), 18.0))


@pytest.mark.parametrize("order", [3, 5])
def test_freqz_matches_jax(order):
    rng = np.random.default_rng(1)
    b = rng.standard_normal((4, order)).astype(np.float32)
    a = np.concatenate([np.ones((4, 1)), 0.2 * rng.standard_normal(
        (4, order - 1))], axis=1).astype(np.float32)
    got = tiir.freqz(_t(b), _t(a), 513)
    want = np.asarray(jiir.freqz(jnp.asarray(b), jnp.asarray(a), 513))
    assert got.dtype == torch.complex64
    _close(torch.view_as_real(got), np.stack([want.real, want.imag], -1),
           atol=1e-5 * np.abs(want).max())


def test_freqz_floors_a_vanishing_denominator_sum():
    """a = (1, -2, 1) sums to exactly zero: the DC bin must stay finite."""
    b = _t([[1.0, 0.0, 0.0]])
    a = _t([[1.0, -2.0, 1.0]])
    got = tiir.freqz(b, a, 65)
    want = np.asarray(jiir.freqz(jnp.asarray(b.numpy()),
                                 jnp.asarray(a.numpy()), 65))
    assert torch.isfinite(torch.view_as_real(got)).all()
    np.testing.assert_allclose(got.numpy()[..., 1:], want[..., 1:],
                               rtol=1e-4, atol=1e-5)
    assert abs(got.numpy()[0, 0]) > 1e6 and abs(want[0, 0]) > 1e6


def test_apply_iir_fsm_and_parametric_eq_match_jax():
    x = _audio(2)
    kw = dict(low_shelf_gain_db=6.0, low_shelf_cutoff_freq=120.0,
              low_shelf_q_factor=0.8,
              band_gains_db=np.array([-9.0, 4.0, 12.0, -3.0], np.float32),
              band_cutoff_freqs=np.array([250.0, 900.0, 3100.0, 8000.0],
                                         np.float32),
              band_q_factors=np.array([0.5, 2.0, 3.5, 1.0], np.float32),
              high_shelf_gain_db=-5.0, high_shelf_cutoff_freq=6000.0,
              high_shelf_q_factor=0.7)
    order = ("low_shelf_gain_db", "low_shelf_cutoff_freq",
             "low_shelf_q_factor", "band_gains_db", "band_cutoff_freqs",
             "band_q_factors", "high_shelf_gain_db",
             "high_shelf_cutoff_freq", "high_shelf_q_factor")
    tb, ta = teq.parametric_eq_sos(SR, *(_t(kw[k]) for k in order))
    jb, ja = jeq.parametric_eq_sos(SR, *(jnp.asarray(kw[k]) for k in order))
    assert tuple(tb.shape) == jb.shape == (6, 3)
    _close(tb, jb, atol=1e-6)
    _close(ta, ja, atol=1e-6)
    _close(tiir.apply_iir_fsm(_t(x), tb, ta, pad=2048),
           jiir.apply_iir_fsm(jnp.asarray(x), jb, ja, pad=2048))
    _close(teq.parametric_eq(_t(x), SR, **{k: _t(v) for k, v in kw.items()}),
           jeq.parametric_eq(jnp.asarray(x), SR,
                             **{k: jnp.asarray(v) for k, v in kw.items()}))
    # the default single band
    _close(teq.parametric_eq(_t(x), SR, low_shelf_gain_db=3.0),
           jeq.parametric_eq(jnp.asarray(x), SR, low_shelf_gain_db=3.0))


def test_linear_recurrence_matches_jax_and_the_serial_loop():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 0.999, (3, 1000)).astype(np.float32)
    b = rng.standard_normal((3, 1000)).astype(np.float32)
    got = tiir.linear_recurrence(_t(a), _t(b)).numpy()
    _close(got, jiir.linear_recurrence(jnp.asarray(a), jnp.asarray(b)),
           atol=1e-4, rtol=1e-4)
    y = np.zeros(3, np.float64)
    serial = []
    for t in range(1000):
        y = a[:, t].astype(np.float64) * y + b[:, t]
        serial.append(y)
    _close(got, np.stack(serial, -1).astype(np.float32), atol=1e-4,
           rtol=1e-4)


@pytest.mark.parametrize("T_", [1, 2, 777])
def test_ballistics_parallel_matches_jax_and_the_serial_scan(T_):
    rng = np.random.default_rng(4)
    c = -np.abs(rng.standard_normal((2, 3, T_)) * 12.0).astype(np.float32)
    aa = rng.uniform(0.5, 0.99, (2, 3)).astype(np.float32)
    ar = rng.uniform(0.9, 0.9999, (2, 3)).astype(np.float32)
    got = tdyn.ballistics_parallel(_t(c), _t(aa), _t(ar))
    _close(got, jdyn.ballistics_parallel(jnp.asarray(c), jnp.asarray(aa),
                                         jnp.asarray(ar)))
    _close(got, tdyn.ballistics_scan(_t(c), _t(aa), _t(ar)))
    _close(tdyn.ballistics_scan(_t(c), _t(aa), _t(ar)),
           jdyn.ballistics_scan(jnp.asarray(c), jnp.asarray(aa),
                                jnp.asarray(ar)))


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(link_channels=False, knee_db=0.5),
    dict(makeup_gain_db=4.0, lookahead_samples=64),
    dict(link_channels=False, exact_ballistics=True),
    dict(active=0.0), dict(active=1.0, lookahead_samples=16),
], ids=["linked", "unlinked", "makeup_lookahead", "exact", "bypassed",
        "active_lookahead"])
def test_compressor_matches_jax(kwargs):
    x = _audio(5, T_=1024)
    common = dict(threshold_db=-24.0, ratio=6.0, attack_ms=2.0,
                  release_ms=60.0)
    _close(tdyn.compressor(_t(x), SR, **common, **kwargs),
           jdyn.compressor(jnp.asarray(x), SR, **common, **kwargs))


def test_bypassed_compressor_returns_the_dry_signal():
    x = _t(_audio(5, T_=512))
    assert torch.equal(tdyn.compressor(x, SR, active=0.0,
                                       lookahead_samples=8), x)


@pytest.mark.parametrize("delay_seconds", [0.0213, 0.69039094])
def test_feedback_delay_matches_jax(delay_seconds):
    """A fractional delay inside the buffer, and one of 33138.77 samples,
    far past it (the integer phase index k*Di then exceeds n many times)."""
    x = _audio(6)
    _close(tdelay.feedback_delay(_t(x), SR, delay_seconds, 0.8677, 0.6),
           jdelay.feedback_delay(jnp.asarray(x), SR, delay_seconds, 0.8677,
                                 0.6))


def test_feedback_delay_phase_index_survives_int32():
    """At T = 2^18 the index k * Di reaches 2^18 * 47999 > 2^31: the int64
    product must keep the low bits the wrapped int32 of the JAX package
    keeps, so the last bins agree."""
    n = 2 ** 19
    k = np.arange(n // 2 + 1, dtype=np.int64)
    wrapped = (k.astype(np.int32) * np.int32(47999)) & (n - 1)
    np.testing.assert_array_equal((k * 47999) & (n - 1), wrapped)


@pytest.mark.parametrize("C", [1, 2])
def test_freeverb_matches_jax(C):
    x = _audio(7, C=C)
    kw = dict(room_size=0.83, damping=0.35, wet_level=0.6, dry_level=0.4,
              width=0.7)
    _close(trev.freeverb(_t(x), SR, **kw),
           jrev.freeverb(jnp.asarray(x), SR, **kw))


def test_freeverb_wet_response_matches_jax():
    got = trev._freeverb_wet_response(1025, 2048, SR, 0.6, 0.4, 23)
    want = np.asarray(jrev._freeverb_wet_response(1025, 2048, SR, 0.6, 0.4,
                                                  23))
    _close(torch.view_as_real(got), np.stack([want.real, want.imag], -1),
           atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------ process_fn


def _stage_params(stage, seed):
    rng = np.random.default_rng(seed)
    return {p.name: np.float32(p.denormalize(rng.uniform(0.15, 0.85)))
            for p in stage.params}


@pytest.mark.parametrize("index", range(5),
                         ids=[s.name for s in basic_chain().stages])
def test_process_fn_matches_jax(index):
    stage = basic_chain().stages[index]
    jstage = jax_basic_chain().stages[index]
    assert stage.param_names == jstage.param_names
    x = _audio(8 + index, C=stage.num_channels)
    p = _stage_params(stage, 20 + index)
    got = stage.process_fn(_t(x), {k: _t(v) for k, v in p.items()}, SR)
    want = jstage.process_fn(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()}, SR)
    _close(got, want)


# ------------------------------------------------------- build_render_fn


def _w(seed, bypassed=()):
    chain = basic_chain()
    w = np.random.default_rng(seed).uniform(
        0.1, 0.9, chain.num_params).astype(np.float32)
    for i, (_, start, _) in enumerate(chain.stage_slices()):
        w[start] = 0.8 if i in bypassed else 0.2
    return w


def _drive(w):
    """The factor the distortion multiplies roundings by: its drive where
    the stage is on and amplifies, else 1."""
    dist, start, _ = basic_chain().stage_slices()[2]
    if w[start] > 0.5:
        return 1.0
    return max(1.0, 10.0 ** (dist.params[0].denormalize(w[start + 1]) / 20.0))


@pytest.mark.parametrize("normalize_stages", [False, True])
@pytest.mark.parametrize("bypassed", [(), (2,), (0, 3), (1, 4)],
                         ids=["all_on", "no_dist", "no_eq_delay",
                              "no_comp_reverb"])
def test_build_render_fn_matches_jax(bypassed, normalize_stages):
    x = _audio(30)
    w = _w(31, bypassed)
    got = build_render_fn(basic_chain(), SR, 2,
                          normalize_stages=normalize_stages,
                          device="cpu")(w, x).numpy()
    want = np.asarray(jax_build_render_fn(
        jax_basic_chain(), SR, 2, normalize_stages=normalize_stages)(
            jnp.asarray(w), jnp.asarray(x)))
    assert got.shape == want.shape == (2, T)
    assert np.abs(got).max() == pytest.approx(1.0, abs=1e-6)
    assert np.abs(got - want).max() <= 5e-5 * _drive(w)


def test_build_render_fn_without_bypass_slots_and_mono_input():
    chain = basic_chain(with_bypass=False)
    assert chain.num_params == 31
    x = _audio(32, C=1)
    w = np.random.default_rng(33).uniform(0.2, 0.6, 31).astype(np.float32)
    # the distortion's drive pinned to 0 dB: a flat tolerance
    d_start = chain.stage_slices()[2][1]
    w[d_start] = 0.5
    got = build_render_fn(chain, SR, 1, peak_normalize_output=False,
                          device="cpu")(w, x).numpy()
    want = np.asarray(jax_build_render_fn(
        jax_basic_chain(with_bypass=False), SR, 1,
        peak_normalize_output=False)(jnp.asarray(w), jnp.asarray(x)))
    assert got.shape == want.shape == (2, T)  # promoted before the delay
    _close(got, want, atol=5e-5)


def test_a_fully_bypassed_chain_returns_the_normalised_input():
    x = _audio(34)
    w = _w(35, bypassed=range(5))
    got = build_render_fn(basic_chain(), SR, 2, device="cpu")(w, x).numpy()
    np.testing.assert_allclose(got, x / np.abs(x).max(), atol=1e-7)
