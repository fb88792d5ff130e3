"""Reverberation — port of ``st_ito_tpu/ops/reverb.py``: the noise-shaped
reverb of the differentiable processor (``noise_shaped_ir``,
``noise_shaped_reverb``: 12 bands of filtered noise, each with its gain and
exponential decay, applied by FFT convolution) and Freeverb (the Schroeder
network behind pedalboard.Reverb: the tunings, and the exact rational
response of the network on the rFFT grid applied with one FFT).

The IR's noise is part of the effect: the JAX package draws it as
``jax.random.normal(PRNGKey(4242), (channels, ir_length))``.
``threefry_bits`` draws the same 32-bit words with numpy (the Threefry-2x32
counter generator in JAX's partitionable layout), and ``_normal`` turns
them into normals as ``jax.random.normal`` does; only the inverse error
function is torch's, which lies within about 2e-5 of XLA's."""

from __future__ import annotations

import math

import numpy as np
import torch

from st_ito_torch.ops.iir import next_pow2

# --------------------------------------------------------------------------
# Noise-shaped reverberation (dasp-style, 12 bands)
# --------------------------------------------------------------------------

_NSR_SEED = 4242  # fixed: the IR noise is part of the effect
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    (x0, x1) under the key pair; uint32 arrays, arithmetic mod 2^32."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def threefry_bits(seed: int, shape: tuple) -> np.ndarray:
    """The uint32 words ``jax.random.bits(jax.random.PRNGKey(seed), shape)``
    draws (JAX's partitionable Threefry layout, its default): element i of
    the flattened shape is the cipher of the counter (i >> 32, i & 0xFFFFFFFF)
    under the key (seed >> 32, seed & 0xFFFFFFFF), its two output words
    XORed."""
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(
            ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF), hi, lo)
    return (b0 ^ b1).reshape(shape)


def _normal(seed: int, shape: tuple) -> torch.Tensor:
    """Standard normals from ``threefry_bits`` as ``jax.random.normal``
    forms them: the top 23 bits as a float32 mantissa in [1, 2), less 1,
    mapped onto [nextafter(-1, 0), 1), then sqrt(2) erfinv(u)."""
    bits = threefry_bits(seed, shape)
    one = np.array(1.0, np.float32)
    u = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, u * (one - lo) + lo)
    return np.float32(math.sqrt(2.0)) * torch.special.erfinv(
        torch.from_numpy(u))


_BAND_NOISE: dict = {}


def _band_noise(ir_length: int, sample_rate: float, num_bands: int,
                channels: int, device) -> torch.Tensor:
    """Static per-band unit-RMS noise, (num_bands, channels, ir_length),
    made once per shape and device."""
    key = (ir_length, float(sample_rate), num_bands, channels, str(device))
    if key not in _BAND_NOISE:
        noise = _normal(_NSR_SEED, (channels, ir_length)).to(device)
        N = torch.fft.rfft(noise, dim=-1)
        freqs = torch.fft.rfftfreq(ir_length, 1.0 / sample_rate,
                                   device=device)
        edges = torch.from_numpy(np.geomspace(
            20.0, 0.95 * sample_rate / 2.0, num_bands + 1).astype(
                np.float32)).to(device)
        mask = ((freqs[None, :] >= edges[:-1, None])
                & (freqs[None, :] < edges[1:, None])).to(torch.float32)
        bands = torch.fft.irfft(N[None] * mask[:, None], n=ir_length, dim=-1)
        rms = torch.sqrt(torch.mean(bands ** 2, dim=-1, keepdim=True))
        _BAND_NOISE[key] = bands / torch.clamp_min(rms, 1e-8)
    return _BAND_NOISE[key]


def noise_shaped_ir(band_gains: torch.Tensor, band_decays: torch.Tensor,
                    sample_rate: float, ir_length: int = 65536,
                    channels: int = 2) -> torch.Tensor:
    """The impulse response, (..., channels, ir_length), of band_gains and
    band_decays (..., num_bands) in [0, 1]; the leading dims batch
    independent IRs.

    decay in [0, 1] maps to T60 in [0.1, 4.1] s; per-band envelope
    10^(-3 t / T60) (-60 dB at t = T60). Each channel is normalised to
    unit energy."""
    band_gains = torch.as_tensor(band_gains, dtype=torch.float32)
    dev = band_gains.device
    band_decays = torch.as_tensor(band_decays, dtype=torch.float32,
                                  device=dev)
    num_bands = band_gains.shape[-1]
    bands = _band_noise(ir_length, sample_rate, num_bands, channels, dev)
    t = torch.arange(ir_length, dtype=torch.float32, device=dev) / sample_rate
    t60 = 0.1 + 4.0 * torch.clamp(band_decays, 0.0, 1.0)
    env = 10.0 ** (-3.0 * t / t60[..., None])  # (..., bands, L)
    ir = torch.einsum("...b,bct,...bt->...ct", band_gains, bands, env)
    energy = torch.sqrt(torch.sum(ir ** 2, dim=-1, keepdim=True))
    return ir / torch.clamp_min(energy, 1e-8)


def noise_shaped_reverb(x: torch.Tensor, sample_rate: float,
                        band_gains: torch.Tensor, band_decays: torch.Tensor,
                        mix, ir_length: int = 65536) -> torch.Tensor:
    """x (..., C, T), C in {1, 2}; band_gains and band_decays (...,
    num_bands) and mix (a number or a (...) tensor) per leading index of x
    (or without leading dims, shared by all). Returns x's shape: the dry
    signal and the wet one (x convolved with its IR) mixed."""
    C, T = x.shape[-2], x.shape[-1]
    ir = noise_shaped_ir(band_gains, band_decays, sample_rate, ir_length,
                         channels=C)
    n = next_pow2(T + ir_length)
    X = torch.fft.rfft(x, n=n, dim=-1)
    H = torch.fft.rfft(ir, n=n, dim=-1)
    wet = torch.fft.irfft(X * H, n=n, dim=-1)[..., :T].to(x.dtype)
    mix = torch.as_tensor(mix, dtype=torch.float32, device=x.device)
    mix = mix[..., None, None]
    return (1.0 - mix) * x + mix * wet


# --------------------------------------------------------------------------
# Freeverb (JUCE/pedalboard.Reverb), exact frequency-domain formulation
# --------------------------------------------------------------------------

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
