"""Memoryless waveshaping — port of ``st_ito_tpu/ops/waveshape.py``'s
``gain`` and ``distortion`` (tanh drive)."""

from __future__ import annotations

import torch


def _db_to_lin(db) -> torch.Tensor:
    return 10.0 ** (torch.as_tensor(db, dtype=torch.float32) / 20.0)


def gain(x: torch.Tensor, gain_db) -> torch.Tensor:
    return x * _db_to_lin(gain_db).to(x.device)


def distortion(x: torch.Tensor, drive_db) -> torch.Tensor:
    return torch.tanh(x * _db_to_lin(drive_db).to(x.device))
