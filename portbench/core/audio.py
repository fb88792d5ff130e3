"""Input audio made from the run's seed on the card, with plain code of
the benchmark's own (nothing the program renders).

``program_audio``: enveloped harmonic partials over a noise floor (white
noise alone would make every candidate embed alike). ``styled``: a clip
through a spectral tilt by FFT and a tanh saturation, the target of an ITO
job: another tone balance and other dynamics than its input."""

from __future__ import annotations

import math

import torch

RATIOS = (1.0, 2.0, 3.01, 5.01, 10.03)
AMPS = (0.3, 0.22, 0.15, 0.1, 0.07)


def generator(seed: int, *salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one item of a run: the seed and the
    item's numbers mixed into one 63-bit seed."""
    h = seed & (2 ** 63 - 1)
    for s in salt:
        h = (h * 1000003 + s + 1) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(h)


def uniform(gen, lo, hi, shape=(), device=None):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def program_audio(gen, channels: int, T: int, sr: int, device) -> torch.Tensor:
    """(channels, T) float32: five partials of a fundamental in [80, 160]
    Hz, each with its own slow envelope and phase, over noise at 0.05."""
    t = torch.arange(T, device=device, dtype=torch.float64) / sr
    f0 = float(uniform(gen, 80.0, 160.0, device=device))
    phases = uniform(gen, 0.0, 2 * math.pi, (len(RATIOS),), device)
    sig = 0.05 * torch.randn((channels, T), generator=gen, device=device)
    for r, a, ph in zip(RATIOS, AMPS, phases.tolist()):
        env = 0.5 + 0.5 * torch.sin(2 * math.pi * (0.31 * a + 0.13) * t)
        sig = sig + (a * env * torch.sin(2 * math.pi * f0 * r * t + ph)
                     ).to(torch.float32)
    return 0.5 * sig / sig.abs().max()


def styled(x: torch.Tensor, gen, sr: int) -> torch.Tensor:
    """x (C, T) with a tilt of +-6 dB an octave about 1 kHz and a tanh
    drive of 1 to 4, peak 0.5."""
    T = x.shape[-1]
    tilt = float(uniform(gen, -1.0, 1.0, device=x.device))
    drive = float(uniform(gen, 1.0, 4.0, device=x.device))
    f = torch.fft.rfftfreq(T, 1.0 / sr).to(x.device)
    gain = (torch.clamp_min(f, 20.0) / 1000.0) ** tilt
    y = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * gain, n=T, dim=-1)
    y = torch.tanh(drive * y / y.abs().max()) / math.tanh(drive)
    return (0.5 * y / y.abs().max()).to(torch.float32)


def pair(seed: int, index: int, channels: int, T: int, sr: int, device):
    """(input, target), each (1, channels, T) float32 on ``device``."""
    gen = generator(seed, index, device=device)
    x = program_audio(gen, channels, T, sr, device)
    y = styled(program_audio(gen, channels, T, sr, device), gen, sr)
    return x[None], y[None]
