"""Paired random audio-effect transforms for contrastive training — port of
``st_ito_tpu/augment.py``.

The reference applies the SAME random effect to two signals by resetting
the global python RNG seed between calls (reference:
st_ito/effects.py:334-362). Here every transform is
``transform(generator, x) -> y`` with its draws from a ``torch.Generator``
on x's device, and ``apply_paired`` gives both signals the same draws by
restoring the generator's state between them. Each transform draws its
parameters first and then whether it applies (probability ``p``), the
JAX trace's order. All take and return (C, T); the set mirrors the
reference's transform inventory (reference: st_ito/effects.py:368-1533).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from st_ito_torch.ops import delay as _delay
from st_ito_torch.ops import dynamics as _dyn
from st_ito_torch.ops import eq as _eq
from st_ito_torch.ops import reverb as _rev
from st_ito_torch.ops import stereo as _st
from st_ito_torch.ops import waveshape as _ws
from st_ito_torch.ops.iir import next_pow2
from st_ito_torch.ops.loudness import loudness_normalize


def _uniform(g, x, lo, hi, shape=()):
    u = torch.rand(shape, generator=g, device=x.device)
    return lo + u * (hi - lo)


def _maybe(g, p, x, y):
    """Apply with probability p (the reference's BaseTransform p)."""
    return y if float(torch.rand((), generator=g, device=x.device)) < p \
        else x


# ---------------------------------------------------------------- simple


def random_swap_lr(g, x, p=0.5):
    return _maybe(g, p, x, _st.swap_channels(x))


def random_gain(g, x, low=0.25, high=1.25, p=0.5):
    return _maybe(g, p, x, x * _uniform(g, x, low, high))


def random_flip_phase(g, x, p=0.5):
    return _maybe(g, p, x, -x)


def random_pan(g, x, p=0.5):
    return _maybe(g, p, x, _st.pan(x, _uniform(g, x, 0.0, 1.0)))


def random_stereo_widener(g, x, p=0.5):
    return _maybe(g, p, x, _st.stereo_widener(x, _uniform(g, x, 0.0, 1.0)))


def _interp(t, nodes):
    """jnp.interp(t, arange(len(nodes)), nodes) for t in [0, n - 1]."""
    i = torch.clamp(t.floor().long(), 0, nodes.shape[0] - 2)
    frac = t - i.to(t.dtype)
    return nodes[i] + frac * (nodes[i + 1] - nodes[i])


def random_volume_automation(g, x, p=0.5, num_nodes: int = 16,
                             max_swing_db: float = 12.0):
    """Piecewise-linear gain curve (reference: effects.py:1095-1153)."""
    T = x.shape[-1]
    nodes_db = _uniform(g, x, -max_swing_db, 0.0, (num_nodes,))
    t = torch.linspace(0.0, num_nodes - 1.0, T, device=x.device)
    curve_db = _interp(t, nodes_db)
    return _maybe(g, p, x, x * 10.0 ** (curve_db / 20.0))


# ---------------------------------------------------------------- effects


def random_parametric_eq(g, x, sample_rate=48000.0, num_bands=3,
                         min_gain_db=-6.0, max_gain_db=6.0, p=0.5):
    """(reference: effects.py:991-1054)"""
    gains = _uniform(g, x, min_gain_db, max_gain_db, (num_bands,))
    freqs = torch.exp(_uniform(g, x, math.log(100.0), math.log(10000.0),
                               (num_bands,)))
    qs = _uniform(g, x, 0.5, 4.0, (num_bands,))
    y = _eq.parametric_eq(x, sample_rate, band_gains_db=gains,
                          band_cutoff_freqs=freqs, band_q_factors=qs)
    return _maybe(g, p, x, y)


def random_compressor(g, x, sample_rate=48000.0, p=0.5):
    """(reference: effects.py:1154-1196)"""
    y = _dyn.compressor(
        x, sample_rate,
        threshold_db=_uniform(g, x, -42.0, -6.0),
        ratio=_uniform(g, x, 1.5, 10.0),
        attack_ms=_uniform(g, x, 1.0, 50.0),
        release_ms=_uniform(g, x, 10.0, 250.0),
    )
    return _maybe(g, p, x, y)


def random_delay(g, x, sample_rate=48000.0, p=0.5):
    """(reference: effects.py:1199-1228)"""
    y = _delay.feedback_delay(
        x, sample_rate,
        delay_seconds=_uniform(g, x, 0.05, 0.7),
        feedback=_uniform(g, x, 0.05, 0.6),
        mix=_uniform(g, x, 0.0, 0.7),
    )
    return _maybe(g, p, x, y)


def random_chorus(g, x, sample_rate=48000.0, p=0.5):
    """(reference: effects.py:1229-1277)"""
    y = _delay.chorus(
        x, sample_rate,
        rate_hz=_uniform(g, x, 0.25, 4.0),
        centre_delay_ms=_uniform(g, x, 3.0, 10.0),
        depth=_uniform(g, x, 0.1, 0.6),
        feedback=_uniform(g, x, 0.0, 0.4),
        mix=_uniform(g, x, 0.1, 0.7),
    )
    return _maybe(g, p, x, y)


def random_phaser(g, x, sample_rate=48000.0, p=0.5):
    """(reference: effects.py:1278-1328)"""
    y = _delay.phaser(
        x, sample_rate,
        rate_hz=_uniform(g, x, 0.2, 2.0),
        depth=_uniform(g, x, 0.2, 0.8),
        centre_frequency_hz=_uniform(g, x, 300.0, 3000.0),
        feedback=_uniform(g, x, 0.0, 0.5),
        mix=_uniform(g, x, 0.1, 0.7),
    )
    return _maybe(g, p, x, y)


def random_limiter(g, x, sample_rate=48000.0, p=0.5):
    """(reference: effects.py:1329-1358)"""
    y = _dyn.limiter(x, sample_rate,
                     threshold_db=_uniform(g, x, -18.0, -2.0),
                     release_ms=_uniform(g, x, 20.0, 300.0))
    return _maybe(g, p, x, y)


def random_distortion(g, x, p=0.5):
    """(reference: effects.py:1359-1378)"""
    y = _ws.distortion(x, _uniform(g, x, 0.0, 24.0))
    return _maybe(g, p, x, y)


def random_sox_reverb(g, x, sample_rate=48000.0, p=0.5):
    """Room-style reverb with the sox parameterisation (reference:
    effects.py:1379-1438 RandomSoxReverb): reverberance and room scale set
    the per-band decay, HF damping the high bands' gain and decay, stereo
    depth the L/R decorrelation of the noise-shaped IR, pre-delay an exact
    phase delay of the wet path, then a wet/dry mix."""
    reverberance = _uniform(g, x, 10.0, 100.0) / 100.0
    hf_damp = _uniform(g, x, 0.0, 100.0) / 100.0
    room_scale = _uniform(g, x, 5.0, 100.0) / 100.0
    stereo_depth = _uniform(g, x, 20.0, 100.0) / 100.0
    wet_dry = _uniform(g, x, 0.0, 1.0)
    pre_delay_ms = _uniform(g, x, 0.0, 100.0)

    num_bands = 8
    frac = torch.linspace(0.0, 1.0, num_bands, device=x.device)
    decay = torch.clamp(reverberance * (0.3 + 0.7 * room_scale), 0.02, 1.0)
    band_decays = decay * (1.0 - 0.6 * hf_damp * frac)
    band_gains = 1.0 - hf_damp * frac

    C, T = x.shape[-2], x.shape[-1]
    ir_length = 32768
    ir = _rev.noise_shaped_ir(band_gains, band_decays, sample_rate,
                              ir_length, channels=C).to(x.device)
    if C == 2:  # stereo depth: blend the decorrelated IR toward its mean
        mono = ir.mean(dim=0, keepdim=True)
        ir = stereo_depth * ir + (1.0 - stereo_depth) * mono
    n = next_pow2(T + ir_length - 1)
    X = torch.fft.rfft(x, n=n, dim=-1)
    H = torch.fft.rfft(ir, n=n, dim=-1)
    w = (2.0 * math.pi * torch.fft.rfftfreq(n, device=x.device)
         * pre_delay_ms * 1e-3 * sample_rate)
    H = H * torch.complex(torch.cos(w), -torch.sin(w))
    wet = torch.fft.irfft(X * H, n=n, dim=-1)[..., :T].to(x.dtype)
    y = (1.0 - wet_dry) * x + wet_dry * wet
    return _maybe(g, p, x, y)


def random_reverb(g, x, sample_rate=48000.0, p=0.5):
    """Freeverb with random params (reference: effects.py:1439-1483,
    RandomPedalboardReverb; the sox flavour is random_sox_reverb)."""
    y = _rev.freeverb(
        x, sample_rate,
        room_size=_uniform(g, x, 0.1, 0.9),
        damping=_uniform(g, x, 0.1, 0.9),
        wet_level=_uniform(g, x, 0.1, 0.5),
        dry_level=0.7,
        width=_uniform(g, x, 0.3, 1.0),
    )
    return _maybe(g, p, x, y)


def mono_to_stereo(g, x):
    """(reference: effects.py:1503-1511)"""
    if x.shape[0] == 1:
        return _st.mono_to_stereo(x)
    return x


def loudness_normalize_transform(g, x, sample_rate=48000.0,
                                 target_lufs=-24.0):
    """(reference: effects.py:1484-1502)"""
    return loudness_normalize(x, sample_rate, target_lufs)


ALL_TRANSFORMS: dict[str, Callable] = {
    "swap_lr": random_swap_lr,
    "gain": random_gain,
    "flip_phase": random_flip_phase,
    "pan": random_pan,
    "stereo_widener": random_stereo_widener,
    "volume_automation": random_volume_automation,
    "parametric_eq": random_parametric_eq,
    "compressor": random_compressor,
    "delay": random_delay,
    "chorus": random_chorus,
    "phaser": random_phaser,
    "limiter": random_limiter,
    "distortion": random_distortion,
    "reverb": random_reverb,
    "sox_reverb": random_sox_reverb,
}


def apply_paired(generator: torch.Generator, x: torch.Tensor,
                 y: torch.Tensor, transforms: Sequence[str] | None = None):
    """The same random transform chain on both signals: each transform
    draws for x, the generator's state is restored, and it draws the same
    for y."""
    for name in list(transforms or ALL_TRANSFORMS.keys()):
        t = ALL_TRANSFORMS[name]
        saved = generator.get_state()
        x = t(generator, x)
        generator.set_state(saved)
        y = t(generator, y)
    return x, y
