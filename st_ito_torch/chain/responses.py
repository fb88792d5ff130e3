"""The population renderer's batched stage functions — port of
``st_ito_tpu/chain/responses.py``'s ``eq_fast_batched`` (K6),
``_eq_section_stack``, ``eq_comp_fast_batched`` (K1) and the nonlinear
stages ``compressor_batched``, ``distortion_batched``, ``limiter_batched``,
plus the multiband compressor's batched form
(``st_ito_tpu/chain/effects.py:282``). Each takes x (B, C, T) and a dict of
(B,) parameters; a function with ``supports_active`` blends its bypass mask
itself (the unlinked compressor inside K7, ``ops/dynamics.py``).
``NL_BATCHED`` maps an effect to its nonlinear batched function."""

from __future__ import annotations

import torch

from st_ito_torch.ops import dynamics as _dyn
from st_ito_torch.ops.dynamics import _time_constant_alpha
from st_ito_torch.ops.kernels.eqcomp import eq_compressor_fused
from st_ito_torch.ops.kernels.scan import biquad_cascade
from st_ito_torch.ops.iir import biquad_coeffs
from st_ito_torch.ops.multiband import multiband_compressor


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


def eq_fast_batched(x, p, sr, active=None, shared_B: int | None = None):
    """The basic EQ alone as one pass of the K6 kernel
    (``ops/kernels/scan.py``). ``active``: optional (B,) float bypass mask
    blended in-kernel. ``shared_B``: x is the population-shared (C, T)
    input for shared_B candidates; the (B, C, T) broadcast is never formed.
    Returns (B, C, T)."""
    b, a = _eq_section_stack(p, sr)
    act = None if active is None else torch.as_tensor(
        active, dtype=torch.float32)[:, None]
    shared_lead_shape = None if shared_B is None else (shared_B, x.shape[0])
    return biquad_cascade(x, b[:, None], a[:, None], active=act,
                          shared_lead_shape=shared_lead_shape)


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


def _col(v):
    return torch.as_tensor(v)[..., None, None]  # (B,) -> (B, 1, 1)


def compressor_batched(x, p, sr, fast: bool, active=None):
    act = None if active is None else torch.as_tensor(
        active, dtype=torch.float32)[:, None]
    return _dyn.compressor(
        x, sr, threshold_db=_col(p["threshold_db"]), ratio=_col(p["ratio"]),
        attack_ms=_col(p["attack_ms"]), release_ms=_col(p["release_ms"]),
        knee_db=0.5, makeup_gain_db=0.0, link_channels=False, fast=fast,
        active=act)


compressor_batched.supports_active = True


def distortion_batched(x, p, sr, fast: bool, active=None):
    del fast
    drive = 10.0 ** (_col(p["drive_db"]) / 20.0)
    out = 10.0 ** (_col(p["output_gain_db"]) / 20.0)
    y = torch.tanh(x * drive) * out
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.float32)[:, None, None]
        y = act * y + (1.0 - act) * x
    return y


distortion_batched.supports_active = True


def limiter_batched(x, p, sr, fast: bool):
    return _dyn.limiter(x, sr, threshold_db=_col(p["threshold_db"]),
                        release_ms=_col(p["release_ms"]), fast=fast)


def multiband_compressor_batched(x, p, sr, fast: bool):
    # crossover frequencies shaped (B, 1): the LR4 response broadcasts as
    # (B, 1, F) against the (B, C, F) spectrum
    return multiband_compressor(
        x, sr, xover_low=torch.as_tensor(p["xover_low_hz"])[..., None],
        xover_high=torch.as_tensor(p["xover_high_hz"])[..., None],
        thresholds_db=(_col(p["low_threshold_db"]),
                       _col(p["mid_threshold_db"]),
                       _col(p["high_threshold_db"])),
        ratios=(_col(p["low_ratio"]), _col(p["mid_ratio"]),
                _col(p["high_ratio"])),
        makeup_db=(_col(p["low_makeup_db"]), _col(p["mid_makeup_db"]),
                   _col(p["high_makeup_db"])),
        attack_ms=_col(p["attack_ms"]), release_ms=_col(p["release_ms"]),
        fast=fast)


NL_BATCHED = {
    "compressor": compressor_batched,
    "distortion": distortion_batched,
    "limiter": limiter_batched,
    "multiband_compressor": multiband_compressor_batched,
}
