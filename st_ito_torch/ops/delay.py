"""Delay-line effects — port of ``st_ito_tpu/ops/delay.py``: the feedback
delay, the chorus and the phaser.

- The feedback delay is LTI for fixed delay and feedback: the wet response
  H(w) = e^{-jwD} / (1 - fb e^{-jwD}) is applied by FFT with a guard of the
  full signal length; a fractional D is exact in the phase term.
- The chorus is a time-varying fractional delay: a gather with linear
  interpolation (``torch.gather`` with a per-candidate index); its feedback
  is unrolled as 4 passes, the loop gain decaying as fb^k.
- The phaser is a cascade of 6 time-varying first-order allpasses, each a
  linear time-varying recurrence: one pass of K11
  (``ops/kernels/scan.py linear_recurrence``) when ``fast``, else the
  doubling scan (``ops/iir.py linear_recurrence``).

The chorus's and the phaser's parameters are scalars (one candidate) or
broadcast to x's leading dims with a trailing time axis, such as (B, 1, 1)
for x (B, C, T)."""

from __future__ import annotations

import math

import torch

from st_ito_torch.ops.iir import linear_recurrence, next_pow2
from st_ito_torch.ops.kernels import scan as _scan


def _f32(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def feedback_delay(x: torch.Tensor, sample_rate: float, delay_seconds,
                   feedback, mix) -> torch.Tensor:
    """y = (1-mix)*x + mix*wet, wet[n] = x[n-D] + fb*wet[n-D]; x (..., T),
    scalar parameters."""
    T = x.shape[-1]
    n = next_pow2(2 * T)
    F = n // 2 + 1
    dev = x.device

    D = _f32(delay_seconds, dev) * sample_rate
    fb = _f32(feedback, dev)
    mix = _f32(mix, dev)

    w = torch.linspace(0.0, math.pi, F, dtype=torch.float32, device=dev)
    # exact integer phase reduction (k*Di) & (n-1), as chain/rp_responses.py
    # delay_build: the product is formed in int64, of which the JAX
    # package's wrapped int32 keeps the same low bits
    Di = torch.floor(D)
    Df = D - Di
    m = (torch.arange(F, dtype=torch.int64, device=dev)
         * Di.to(torch.int64)) & (n - 1)
    theta = (2.0 * math.pi / n) * m.to(torch.float32) + w * Df
    zD = torch.complex(torch.cos(theta), -torch.sin(theta))
    H = zD / (1.0 - fb * 0.999 * zD)  # 0.999 bounds the tail at fb = 1

    X = torch.fft.rfft(x, n=n, dim=-1)
    wet = torch.fft.irfft(X * H, n=n, dim=-1)[..., :T].to(x.dtype)
    return (1.0 - mix) * x + mix * wet


def chorus(x: torch.Tensor, sample_rate: float, rate_hz, centre_delay_ms,
           depth, feedback, mix, num_feedback_passes: int = 4
           ) -> torch.Tensor:
    """LFO-modulated fractional delay (pedalboard.Chorus-style) on x
    (..., C, T)."""
    T = x.shape[-1]
    dev = x.device
    t = torch.arange(T, dtype=torch.float32, device=dev)
    centre = _f32(centre_delay_ms, dev) * 1e-3 * sample_rate
    depth_samp = _f32(depth, dev) * 0.5 * centre
    lfo = torch.sin(2.0 * math.pi * _f32(rate_hz, dev) * t / sample_rate)
    d = torch.clamp_min(centre + depth_samp * lfo, 1.0)  # delay in samples

    # the read positions, their two neighbours' indices and the weights are
    # the same for every pass: formed once, one index row per candidate
    pos = torch.clamp(t - d, 0.0, T - 1.0)
    floor = torch.floor(pos)
    i0 = floor.to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, T - 1)
    frac = pos - floor
    mask = (t >= d).to(x.dtype)

    def frac_delay(sig):
        lo = torch.gather(sig, -1, i0.expand(sig.shape))
        hi = torch.gather(sig, -1, i1.expand(sig.shape))
        return ((1.0 - frac) * lo + frac * hi) * mask

    fb = _f32(feedback, dev) * 0.95
    wet = frac_delay(x)
    acc = wet
    for _ in range(num_feedback_passes):
        wet = frac_delay(wet) * fb
        acc = acc + wet
    mix = _f32(mix, dev)
    return (1.0 - mix) * x + mix * acc


def phaser(x: torch.Tensor, sample_rate: float, rate_hz, depth,
           centre_frequency_hz, feedback, mix, num_stages: int = 6,
           fast: bool = False) -> torch.Tensor:
    """Cascade of LFO-swept first-order allpasses (pedalboard.Phaser-style)
    on x (..., C, T). Each stage is y[n] = -a[n-1] y[n-1] + a[n] x[n] +
    x[n-1], a linear time-varying recurrence: K11 when ``fast`` (its plain
    version on a CPU tensor), else the doubling scan."""
    T = x.shape[-1]
    dev = x.device
    t = torch.arange(T, dtype=torch.float32, device=dev)
    lfo = 0.5 * (1.0 + torch.sin(
        2.0 * math.pi * _f32(rate_hz, dev) * t / sample_rate))
    centre = _f32(centre_frequency_hz, dev)
    depth = _f32(depth, dev)
    # sweep one octave either side of centre, scaled by depth
    f = centre * 2.0 ** (depth * (2.0 * lfo - 1.0))
    f = torch.clamp(f, 20.0, 0.49 * sample_rate)
    tan_half = torch.tan(math.pi * f / sample_rate)
    a = (tan_half - 1.0) / (tan_half + 1.0)
    a_prev = torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)
    # the recurrence's coefficient is the same in every stage: written out
    # at x's shape once, the (lanes, T) rows K11 reads
    coeff = (-a_prev).expand(x.shape).to(x.dtype)
    if fast:
        coeff = coeff.contiguous()

    def allpass(sig):
        sig_prev = torch.cat([torch.zeros_like(sig[..., :1]),
                              sig[..., :-1]], dim=-1)
        drive = a * sig + sig_prev
        if fast:
            return _scan.linear_recurrence(coeff, drive)
        return linear_recurrence(coeff, drive)

    wet = x
    for _ in range(num_stages):
        wet = allpass(wet)
    fb = _f32(feedback, dev)
    wet = wet + fb * x  # a feed-forward approximation of the loop feedback
    mix = _f32(mix, dev)
    return (1.0 - mix) * x + mix * 0.5 * (x + wet)
