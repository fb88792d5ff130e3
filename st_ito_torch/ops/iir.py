"""Biquad design (RBJ Audio-EQ cookbook) — port of the parts of
``st_ito_tpu/ops/iir.py`` the basic EQ needs: ``biquad_coeffs`` for the
low-shelf, peaking and high-shelf sections, and ``next_pow2``."""

from __future__ import annotations

import math

import torch

_FILTER_TYPES = ("low_shelf", "high_shelf", "peaking")


def biquad_coeffs(gain_db, cutoff_freq, q_factor, sample_rate: float,
                  filter_type: str):
    """RBJ cookbook biquad. Returns (b, a), each shape (..., 3),
    a0-normalized, float32. Inputs broadcast against each other."""
    if filter_type not in _FILTER_TYPES:
        raise NotImplementedError(
            f"filter_type {filter_type!r} is not ported yet (ROADMAP §1 "
            f"item 7); the basic EQ uses {_FILTER_TYPES}")
    gain_db, cutoff_freq, q_factor = torch.broadcast_tensors(
        torch.as_tensor(gain_db, dtype=torch.float32),
        torch.as_tensor(cutoff_freq, dtype=torch.float32),
        torch.as_tensor(q_factor, dtype=torch.float32),
    )

    A = torch.pow(10.0, gain_db / 40.0)
    w0 = 2.0 * math.pi * (cutoff_freq / sample_rate)
    alpha = torch.sin(w0) / (2.0 * q_factor)
    cos_w0 = torch.cos(w0)
    sqrt_A = torch.sqrt(A)

    if filter_type == "high_shelf":
        b0 = A * ((A + 1) + (A - 1) * cos_w0 + 2 * sqrt_A * alpha)
        b1 = -2 * A * ((A - 1) + (A + 1) * cos_w0)
        b2 = A * ((A + 1) + (A - 1) * cos_w0 - 2 * sqrt_A * alpha)
        a0 = (A + 1) - (A - 1) * cos_w0 + 2 * sqrt_A * alpha
        a1 = 2 * ((A - 1) - (A + 1) * cos_w0)
        a2 = (A + 1) - (A - 1) * cos_w0 - 2 * sqrt_A * alpha
    elif filter_type == "low_shelf":
        b0 = A * ((A + 1) - (A - 1) * cos_w0 + 2 * sqrt_A * alpha)
        b1 = 2 * A * ((A - 1) - (A + 1) * cos_w0)
        b2 = A * ((A + 1) - (A - 1) * cos_w0 - 2 * sqrt_A * alpha)
        a0 = (A + 1) + (A - 1) * cos_w0 + 2 * sqrt_A * alpha
        a1 = -2 * ((A - 1) + (A + 1) * cos_w0)
        a2 = (A + 1) + (A - 1) * cos_w0 - 2 * sqrt_A * alpha
    else:  # peaking
        b0 = 1 + alpha * A
        b1 = -2 * cos_w0
        b2 = 1 - alpha * A
        a0 = 1 + alpha / A
        a1 = -2 * cos_w0
        a2 = 1 - alpha / A

    b = torch.stack([b0, b1, b2], dim=-1) / a0[..., None]
    a = torch.stack([a0, a1, a2], dim=-1) / a0[..., None]
    return b, a


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()
