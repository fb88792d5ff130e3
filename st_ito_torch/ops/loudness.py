"""ITU-R BS.1770-4 integrated loudness (LUFS), batched — port of
``st_ito_tpu/ops/loudness.py``.

The K-weighting prefilter (a high shelf and the RLB highpass, designed at
the working sample rate from the analog prototypes, as pyloudnorm designs
them) applied by frequency sampling (``ops/iir.py apply_iir_fsm``), then
400 ms mean-square blocks at a 100 ms hop with the absolute (-70 LUFS) and
relative (-10 LU) gates, all as masks over every block at once.
"""

from __future__ import annotations

import math

import torch

from st_ito_torch.ops.iir import apply_iir_fsm


def _k_weighting_sos(sample_rate: float, device=None):
    """The two BS.1770 prefilter sections (b, a), each (2, 3) float32."""
    # stage 1: high shelf, +4 dB, f0=1681.97 Hz, Q=0.7072, G=3.99984 dB
    f0 = 1681.9744509555319
    G = 3.99984385397
    Q = 0.7071752369554193
    K = math.tan(math.pi * f0 / sample_rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0_ = 1.0 + K / Q + K * K
    shelf_b = [(Vh + Vb * K / Q + K * K) / a0_, 2.0 * (K * K - Vh) / a0_,
               (Vh - Vb * K / Q + K * K) / a0_]
    shelf_a = [1.0, 2.0 * (K * K - 1.0) / a0_, (1.0 - K / Q + K * K) / a0_]

    # stage 2: highpass, f0=38.135 Hz, Q=0.5003
    f0 = 38.13547087613982
    Q = 0.5003270373253953
    K = math.tan(math.pi * f0 / sample_rate)
    a0_ = 1.0 + K / Q + K * K
    hp_b = torch.tensor([1.0, -2.0, 1.0], dtype=torch.float32) / a0_
    hp_a = [1.0, 2.0 * (K * K - 1.0) / a0_, (1.0 - K / Q + K * K) / a0_]

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32)

    b = torch.stack([f32(shelf_b), hp_b])
    a = torch.stack([f32(shelf_a), f32(hp_a)])
    return b.to(device), a.to(device)


def k_weight(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    b, a = _k_weighting_sos(sample_rate, x.device)
    return apply_iir_fsm(x, b, a, pad=4096)


def integrated_loudness(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Integrated LUFS of x (..., C, T) -> (...,). Channel weights are 1;
    a signal shorter than one 400 ms block reads as its one block
    (indices clamped to the end); silence reads the mean-square floor,
    -0.691 + 10 log10(1e-12)."""
    y = k_weight(x, sample_rate)

    block = int(round(0.400 * sample_rate))
    hop = int(round(0.100 * sample_rate))
    T = y.shape[-1]
    n_blocks = max((T - block) // hop + 1, 1)

    idx = (torch.arange(n_blocks, device=y.device)[:, None] * hop
           + torch.arange(block, device=y.device)[None, :])
    idx = torch.clamp_max(idx, T - 1)
    frames = y[..., idx]  # (..., C, n_blocks, block)
    z = torch.mean(frames**2, dim=-1)  # (..., C, n_blocks)
    z_sum = torch.sum(z, dim=-2)  # (..., n_blocks)

    eps = 1e-12
    block_loudness = -0.691 + 10.0 * torch.log10(torch.clamp_min(z_sum, eps))

    abs_mask = block_loudness > -70.0
    denom = torch.clamp_min(abs_mask.sum(dim=-1), 1)
    z_abs = torch.where(abs_mask, z_sum, 0.0).sum(dim=-1) / denom
    rel_threshold = (-0.691 + 10.0 * torch.log10(torch.clamp_min(z_abs, eps))
                     - 10.0)

    rel_mask = abs_mask & (block_loudness > rel_threshold[..., None])
    denom = torch.clamp_min(rel_mask.sum(dim=-1), 1)
    z_gated = torch.where(rel_mask, z_sum, 0.0).sum(dim=-1) / denom
    lufs = -0.691 + 10.0 * torch.log10(torch.clamp_min(z_gated, eps))
    return torch.clamp_min(lufs, -200.0)


def loudness_normalize(x: torch.Tensor, sample_rate: float,
                       target_lufs: float = -22.0) -> torch.Tensor:
    """Gain x (..., C, T) to the target integrated loudness."""
    lufs = integrated_loudness(x, sample_rate)
    g = 10.0 ** ((target_lufs - lufs) / 20.0)
    return x * g[..., None, None]
