"""The basic EQ's biquad stack and the fused EQ -> compressor (->
distortion) head — port of ``st_ito_tpu/chain/responses.py:81-138``."""

from __future__ import annotations

import torch

from st_ito_torch.ops.dynamics import _time_constant_alpha
from st_ito_torch.ops.kernels.eqcomp import eq_compressor_fused
from st_ito_torch.ops.iir import biquad_coeffs


def _eq_section_stack(p, sr):
    """(B, 6, 3) biquad coefficient stacks for the basic parametric EQ."""
    sections = [biquad_coeffs(p["low_shelf_gain_db"],
                              p["low_shelf_cutoff_freq"],
                              p["low_shelf_q_factor"], sr, "low_shelf")]
    for i in range(4):
        sections.append(biquad_coeffs(p[f"band{i}_gain_db"],
                                      p[f"band{i}_cutoff_freq"],
                                      p[f"band{i}_q_factor"], sr, "peaking"))
    sections.append(biquad_coeffs(p["high_shelf_gain_db"],
                                  p["high_shelf_cutoff_freq"],
                                  p["high_shelf_q_factor"], sr, "high_shelf"))
    b = torch.stack([s[0] for s in sections], dim=-2)
    a = torch.stack([s[1] for s in sections], dim=-2)
    return b, a


def eq_comp_fast_batched(x, p_eq, p_comp, sr, active_eq=None,
                         active_comp=None, p_dist=None, active_dist=None,
                         shared_B: int | None = None):
    """Adjacent EQ -> compressor (-> distortion) stages as ONE pass of the
    K1 kernel (``ops/kernels/eqcomp.py``). ``active_*``: optional (B,)
    float bypass masks blended at each stage boundary. ``shared_B``: x is
    the population-shared (C, T) input for shared_B candidates; the
    (B, C, T) broadcast is never formed. Returns (B, C, T)."""
    b, a = _eq_section_stack(p_eq, sr)

    def col(v):  # (B,) -> (B, 1) broadcast over channels
        return torch.as_tensor(v, dtype=torch.float32)[:, None]

    shared_lead_shape = None if shared_B is None else (shared_B, x.shape[0])
    return eq_compressor_fused(
        x, b[:, None], a[:, None],
        shared_lead_shape=shared_lead_shape,
        threshold_db=col(p_comp["threshold_db"]),
        ratio=col(p_comp["ratio"]),
        knee_db=0.5,
        alpha_attack=col(_time_constant_alpha(p_comp["attack_ms"], sr)),
        alpha_release=col(_time_constant_alpha(p_comp["release_ms"], sr)),
        makeup_gain_db=0.0,
        eq_active=None if active_eq is None else col(active_eq),
        comp_active=None if active_comp is None else col(active_comp),
        drive_db=None if p_dist is None else col(p_dist["drive_db"]),
        dist_gain_db=(0.0 if p_dist is None
                      else col(p_dist["output_gain_db"])),
        dist_active=None if active_dist is None else col(active_dist),
    )
