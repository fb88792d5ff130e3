"""Compressor helpers — port of ``st_ito_tpu/ops/dynamics.py``'s
``_time_constant_alpha`` and ``gain_computer`` (the fused K1 kernel in
``ops/kernels/eqcomp.py`` inlines the same gain computer per sample)."""

from __future__ import annotations

import torch


def _time_constant_alpha(time_ms, sample_rate: float) -> torch.Tensor:
    """One-pole smoothing coefficient for a given time constant."""
    time_ms = torch.clamp_min(torch.as_tensor(time_ms, dtype=torch.float32),
                              1e-3)
    return torch.exp(-1.0 / (time_ms * 0.001 * sample_rate))


def gain_computer(env_db, threshold_db, ratio, knee_db) -> torch.Tensor:
    """Static soft-knee gain computer. Returns gain reduction in dB (<= 0)."""
    env_db = torch.as_tensor(env_db, dtype=torch.float32)
    threshold_db = torch.as_tensor(threshold_db, dtype=torch.float32)
    ratio = torch.as_tensor(ratio, dtype=torch.float32)
    knee_db = torch.clamp_min(torch.as_tensor(knee_db, dtype=torch.float32),
                              1e-3)

    over = env_db - threshold_db
    slope = 1.0 / ratio - 1.0
    knee_region = slope * (over + knee_db / 2.0) ** 2 / (2.0 * knee_db)
    above = slope * over
    return torch.where(
        2.0 * over < -knee_db,
        torch.zeros_like(over),
        torch.where(2.0 * over > knee_db, above, knee_region),
    )
