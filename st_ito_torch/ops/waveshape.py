"""Memoryless waveshaping — port of ``st_ito_tpu/ops/waveshape.py``'s
``gain``, ``distortion`` (tanh drive), ``flip_phase``, ``fade_in`` and
``peak_normalize``."""

from __future__ import annotations

import torch


def _db_to_lin(db) -> torch.Tensor:
    return 10.0 ** (torch.as_tensor(db, dtype=torch.float32) / 20.0)


def gain(x: torch.Tensor, gain_db) -> torch.Tensor:
    return x * _db_to_lin(gain_db).to(x.device)


def distortion(x: torch.Tensor, drive_db) -> torch.Tensor:
    return torch.tanh(x * _db_to_lin(drive_db).to(x.device))


def flip_phase(x: torch.Tensor) -> torch.Tensor:
    return -x


def fade_in(x: torch.Tensor, num_samples: int = 16384) -> torch.Tensor:
    """Linear fade-in over the first num_samples."""
    n = min(num_samples, x.shape[-1])
    ramp = torch.linspace(0.0, 1.0, n, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., :n] * ramp, x[..., n:]], dim=-1)


def peak_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Each (..., C, T) item over its own peak, leading dims kept."""
    peak = torch.amax(x.abs(), dim=(-2, -1), keepdim=True)
    return x / torch.clamp_min(peak, eps)
