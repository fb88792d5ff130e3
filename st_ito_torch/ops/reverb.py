"""Freeverb (the Schroeder network behind pedalboard.Reverb) — port of
``st_ito_tpu/ops/reverb.py:95-186``: the tunings, and the exact rational
response of the network on the rFFT grid applied with one FFT."""

from __future__ import annotations

import math

import torch

from st_ito_torch.ops.iir import next_pow2

_COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)  # @44.1 kHz
_ALLPASS_TUNINGS = (556, 441, 341, 225)
_STEREO_SPREAD = 23


def _freeverb_wet_response(n_freqs: int, fft_size: int, sample_rate: float,
                           room_size, damping, spread: int, device=None):
    """Exact response of (sum of 8 damped combs) -> (4 allpasses) for one
    channel whose tunings are offset by ``spread`` samples; complex64
    (n_freqs,)."""
    w = torch.linspace(0.0, math.pi, n_freqs, dtype=torch.float32,
                       device=device)
    z1 = torch.complex(torch.cos(w), -torch.sin(w))  # z^-1
    kk = torch.arange(n_freqs, dtype=torch.int64, device=device)

    def lag_z(D: int):
        # exact integer phase reduction of w*D
        m = (kk * D) & (fft_size - 1)
        th = (2.0 * math.pi / fft_size) * m.to(torch.float32)
        return torch.complex(torch.cos(th), -torch.sin(th))

    feedback = torch.as_tensor(room_size, dtype=torch.float32,
                               device=device) * 0.28 + 0.7
    damp = torch.as_tensor(damping, dtype=torch.float32, device=device) * 0.4

    comb_sum = torch.zeros(n_freqs, dtype=torch.complex64, device=device)
    for tune in _COMB_TUNINGS:
        zD = lag_z(int(sample_rate * (tune + spread) / 44100.0))
        # comb with one-pole damping in the feedback path:
        #   out = z^-D (1 - d z^-1) / (1 - d z^-1 - fb (1-d) z^-D)
        one_pole = 1.0 - damp * z1
        comb_sum = comb_sum + zD * one_pole / (
            one_pole - feedback * (1.0 - damp) * zD)

    ap = torch.ones(n_freqs, dtype=torch.complex64, device=device)
    for tune in _ALLPASS_TUNINGS:
        zD = lag_z(int(sample_rate * (tune + spread) / 44100.0))
        # JUCE allpass: y[n] = b[n] - x[n], b[n] = x[n-D] + 0.5 b[n-D]
        ap = ap * ((1.5 * zD - 1.0) / (1.0 - 0.5 * zD))

    return comb_sum * ap


def freeverb(x: torch.Tensor, sample_rate: float, room_size=0.5, damping=0.5,
             wet_level=0.33, dry_level=0.4, width=1.0) -> torch.Tensor:
    """pedalboard.Reverb / juce::Reverb semantics on (..., C, T), C in
    {1, 2}; scalar parameters. JUCE scale factors: wetScale = 3,
    dryScale = 2, input gain 0.015, right-channel tunings offset by 23
    samples; wet1/wet2 implement the stereo width."""
    C, T = x.shape[-2], x.shape[-1]
    n = next_pow2(2 * T)
    nf = n // 2 + 1
    dev = x.device

    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    H_L = _freeverb_wet_response(nf, n, sample_rate, room_size, damping, 0,
                                 dev)
    gain_in = 0.015
    wet_level, dry_level, width = (scalar(wet_level), scalar(dry_level),
                                   scalar(width))
    dry_gain = dry_level * 2.0

    if C == 1:
        X = torch.fft.rfft(x, n=n, dim=-1)
        wet = torch.fft.irfft(X * (gain_in * H_L), n=n, dim=-1)[..., :T]
        # mono: wet1 + wet2 collapse to wet*3 (width irrelevant)
        return (dry_gain * x + 3.0 * wet_level * wet).to(x.dtype)

    H_R = _freeverb_wet_response(nf, n, sample_rate, room_size, damping,
                                 _STEREO_SPREAD, dev)
    wet1 = 0.5 * wet_level * 3.0 * (1.0 + width)
    wet2 = 0.5 * wet_level * 3.0 * (1.0 - width)

    mono_in = (x[..., 0, :] + x[..., 1, :]) * gain_in
    M = torch.fft.rfft(mono_in, n=n, dim=-1)
    wet_L = torch.fft.irfft(M * H_L, n=n, dim=-1)[..., :T]
    wet_R = torch.fft.irfft(M * H_R, n=n, dim=-1)[..., :T]

    out_L = wet1 * wet_L + wet2 * wet_R + dry_gain * x[..., 0, :]
    out_R = wet1 * wet_R + wet2 * wet_L + dry_gain * x[..., 1, :]
    return torch.stack([out_L, out_R], dim=-2).to(x.dtype)
