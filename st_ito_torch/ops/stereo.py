"""Stereo width — port of ``st_ito_tpu/ops/stereo.py``'s ``to_mid_side``,
``from_mid_side``, ``stereo_widener``, ``pan``, ``mono_to_stereo`` and
``swap_channels``."""

from __future__ import annotations

import math

import torch


def to_mid_side(x: torch.Tensor) -> torch.Tensor:
    """(..., 2, T) -> (..., 2, T) with [mid, side] = [(L+R)/2, (L-R)/2]."""
    mid = (x[..., 0, :] + x[..., 1, :]) / 2.0
    side = (x[..., 0, :] - x[..., 1, :]) / 2.0
    return torch.stack([mid, side], dim=-2)


def from_mid_side(ms: torch.Tensor) -> torch.Tensor:
    left = ms[..., 0, :] + ms[..., 1, :]
    right = ms[..., 0, :] - ms[..., 1, :]
    return torch.stack([left, right], dim=-2)


def stereo_widener(x: torch.Tensor, width) -> torch.Tensor:
    """width in [0, 1]: 0 = mono, 0.5 = unchanged, 1 = maximally wide.
    Energy-preserving mid/side scaling."""
    width = torch.as_tensor(width, dtype=torch.float32, device=x.device)
    sqrt2 = math.sqrt(2.0)
    mid_gain = torch.sqrt(torch.clamp(1.0 - width, 0.0, 1.0)) * sqrt2
    side_gain = torch.sqrt(torch.clamp(width, 0.0, 1.0)) * sqrt2
    ms = to_mid_side(x)
    ms = torch.stack([ms[..., 0, :] * mid_gain, ms[..., 1, :] * side_gain],
                     dim=-2)
    return from_mid_side(ms)


def pan(x: torch.Tensor, pan_position) -> torch.Tensor:
    """Constant-power pan, pan_position in [0, 1] (0.5 = centre): the two
    channels of x (..., 2, T) summed to mono, then panned."""
    theta = torch.as_tensor(pan_position, dtype=torch.float32,
                            device=x.device) * (math.pi / 2.0)
    mono = x.mean(dim=-2)
    left = torch.cos(theta) * mono
    right = torch.sin(theta) * mono
    return torch.stack([left, right], dim=-2) * math.sqrt(2.0)


def mono_to_stereo(x: torch.Tensor) -> torch.Tensor:
    """(..., 1, T) -> (..., 2, T) by duplication."""
    return torch.cat([x, x], dim=-2)


def swap_channels(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-2)
