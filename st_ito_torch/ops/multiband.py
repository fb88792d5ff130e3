"""The multiband compressor — port of ``st_ito_tpu/ops/multiband.py``.

Linkwitz-Riley 4th-order crossovers (two cascaded Butterworth biquads per
edge, applied by frequency sampling with ``torch.fft``, as the JAX package
applies them in XLA outside any kernel) split the signal into 3 bands; each
band gets its own linked feed-forward compressor and makeup gain, then the
bands sum. With ``fast=True`` each band's ballistics run through K8.
"""

from __future__ import annotations

import torch

from st_ito_torch.ops.dynamics import compressor
from st_ito_torch.ops.iir import apply_iir_fsm, biquad_coeffs


def _lr4(x: torch.Tensor, freq, sample_rate, kind: str) -> torch.Tensor:
    """4th-order Linkwitz-Riley low/high pass = squared Butterworth."""
    freq = torch.as_tensor(freq, dtype=torch.float32, device=x.device)
    b, a = biquad_coeffs(0.0, freq, 0.7071, sample_rate, kind)
    b2 = torch.stack([b, b], dim=-2)
    a2 = torch.stack([a, a], dim=-2)
    return apply_iir_fsm(x, b2, a2, pad=8192)


def split_bands(x: torch.Tensor, sample_rate, f_low, f_high):
    """(..., T) -> (low, mid, high) with LR4 crossovers."""
    low = _lr4(x, f_low, sample_rate, "lowpass")
    rest = _lr4(x, f_low, sample_rate, "highpass")
    mid = _lr4(rest, f_high, sample_rate, "lowpass")
    high = _lr4(rest, f_high, sample_rate, "highpass")
    return low, mid, high


def multiband_compressor(x: torch.Tensor, sample_rate: float,
                         xover_low=250.0, xover_high=4000.0,
                         thresholds_db=(-24.0, -24.0, -24.0),
                         ratios=(4.0, 4.0, 4.0), makeup_db=(0.0, 0.0, 0.0),
                         attack_ms=10.0, release_ms=150.0,
                         fast: bool = False) -> torch.Tensor:
    """x (..., C, T). thresholds/ratios/makeup per band (low, mid, high)."""
    bands = split_bands(x, sample_rate, xover_low, xover_high)
    out = None
    for band, th, ratio, mk in zip(bands, thresholds_db, ratios, makeup_db):
        y = compressor(band, sample_rate, threshold_db=th, ratio=ratio,
                       attack_ms=attack_ms, release_ms=release_ms,
                       knee_db=3.0, makeup_gain_db=mk, fast=fast)
        out = y if out is None else out + y
    return out
