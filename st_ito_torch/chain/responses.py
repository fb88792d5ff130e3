"""The population renderer's batched stage functions — port of
``st_ito_tpu/chain/responses.py``: ``eq_fast_batched`` (K6),
``_eq_section_stack``, ``eq_comp_fast_batched`` (K1), the nonlinear stages
``compressor_batched``, ``distortion_batched``, ``limiter_batched``,
``noise_gate_batched`` (K8 when fast), ``chorus_batched`` and
``phaser_batched`` (K11 when fast), plus the multiband compressor's batched
form (``st_ito_tpu/chain/effects.py:282``); and the per-stage LTI response
path: each LTI stage's frequency response batched over the population
(``eq_response``, ``delay_response``, ``gain_response``,
``widener_response``, ``freeverb_response``), ``bypass_blend``,
``compose_responses`` and ``apply_response``.

Each batched function takes x (B, C, T) and a dict of (B,) parameters and
is batched by broadcasting, never by a loop over candidates; a function
with ``supports_active`` blends its bypass mask itself (the unlinked
compressor inside K7, ``ops/dynamics.py``). ``NL_BATCHED`` maps an effect
to its nonlinear batched function.

A response is one of
  ("scalar", H)           H (B, F), the same on every channel;
  ("monomix", (D, GL, GR)) the structured stereo mix
                          y_L = D x_L + GL (x_L + x_R),
                          y_R = D x_R + GR (x_L + x_R), closed under
                          composition (the widener, the stereo reverb);
  ("matrix", H)           a generic (B, 2, 2, F) mix.
"""

from __future__ import annotations

import math

import torch

from st_ito_torch.ops import delay as _delay
from st_ito_torch.ops import dynamics as _dyn
from st_ito_torch.ops.dynamics import _time_constant_alpha
from st_ito_torch.ops.kernels.eqcomp import eq_compressor_fused
from st_ito_torch.ops.kernels.scan import biquad_cascade
from st_ito_torch.ops.iir import _eval_biquad_poly, _unit_circle_uv
from st_ito_torch.ops.iir import biquad_coeffs
from st_ito_torch.ops.multiband import multiband_compressor
from st_ito_torch.ops.reverb import (_ALLPASS_TUNINGS, _COMB_TUNINGS,
                                     _STEREO_SPREAD)


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


def noise_gate_batched(x, p, sr, fast: bool):
    return _dyn.noise_gate(x, sr, _col(p["threshold_db"]), _col(p["ratio"]),
                           _col(p["attack_ms"]), _col(p["release_ms"]),
                           fast=fast)


def chorus_batched(x, p, sr, fast: bool):
    del fast
    return _delay.chorus(x, sr, _col(p["rate_hz"]),
                         _col(p["centre_delay_ms"]), _col(p["depth"]),
                         _col(p["feedback"]), _col(p["mix"]))


def phaser_batched(x, p, sr, fast: bool):
    return _delay.phaser(x, sr, _col(p["rate_hz"]), _col(p["depth"]),
                         _col(p["centre_frequency_hz"]), _col(p["feedback"]),
                         _col(p["mix"]), fast=fast)


NL_BATCHED = {
    "compressor": compressor_batched,
    "distortion": distortion_batched,
    "limiter": limiter_batched,
    "multiband_compressor": multiband_compressor_batched,
    "noise_gate": noise_gate_batched,
    "chorus": chorus_batched,
    "phaser": phaser_batched,
}


# ------------------------------------------------------------ LTI responses


def _freqz_omega(b, a, omega):
    """b, a (..., 3); omega (F,). (..., F) complex64, evaluated in the
    cancellation-stable form (``ops/iir.py _eval_biquad_poly``)."""
    u, v = _unit_circle_uv(omega)
    return (_eval_biquad_poly(b, u, v, floor_sum=False)
            / _eval_biquad_poly(a, u, v, floor_sum=True))


def eq_response(p: dict, omega, sr: float, channels: int):
    b, a = _eq_section_stack(p, sr)
    H = None
    for s in range(b.shape[-2]):
        Hs = _freqz_omega(b[..., s, :], a[..., s, :], omega)
        H = Hs if H is None else H * Hs
    return ("scalar", H)


def _cis_neg(theta):
    return torch.complex(torch.cos(theta), -torch.sin(theta))


def reduced_phase(omega, D, n: int | None):
    """theta = omega * D reduced exactly on the grid omega_k = 2 pi k / n:
    D split into whole and fractional parts, (k * Di) & (n - 1) formed in
    int64, of which the JAX package's wrapped int32 keeps the same low
    bits."""
    F = omega.shape[-1]
    n_grid = 2 * (F - 1)
    assert n is None or n_grid == n
    k = torch.arange(F, dtype=torch.int64, device=omega.device)
    D = torch.as_tensor(D, dtype=torch.float32, device=omega.device)
    Di = torch.floor(D)
    Df = D - Di
    m = (k * Di.to(torch.int64)) & (n_grid - 1)
    return (2.0 * math.pi / n_grid) * m.to(torch.float32) + omega * Df


def delay_response(p: dict, omega, sr: float, channels: int):
    dev = omega.device
    D = torch.as_tensor(p["delay_seconds"], device=dev)[..., None] * sr
    fb = torch.as_tensor(p["feedback"], device=dev)[..., None] * 0.999
    mix = torch.as_tensor(p["mix"], device=dev)[..., None]
    zD = _cis_neg(reduced_phase(omega, D, None))
    H_wet = zD / (1.0 - fb * zD)
    return ("scalar", (1.0 - mix) + mix * H_wet)


def gain_response(p: dict, omega, sr: float, channels: int):
    g = 10.0 ** (torch.as_tensor(p["gain_db"], device=omega.device) / 20.0)
    return ("scalar", g[..., None].to(torch.complex64)
            * torch.ones_like(omega, dtype=torch.complex64))


def widener_response(p: dict, omega, sr: float, channels: int):
    width = torch.as_tensor(p["width"], device=omega.device)
    sqrt2 = math.sqrt(2.0)
    mg = torch.sqrt(torch.clamp(1.0 - width, 0.0, 1.0)) * sqrt2
    sg = torch.sqrt(torch.clamp(width, 0.0, 1.0)) * sqrt2
    a = (mg + sg) / 2.0
    b = (mg - sg) / 2.0
    # [[a, b], [b, a]] = (a - b) I + b 1 1^T: the monomix form
    G = b[..., None].to(torch.complex64)
    return ("monomix", ((a - b)[..., None].to(torch.complex64), G, G))


def _static_lag_z(omega, D: int):
    """z^-D on the rfft grid with the integer phase reduced exactly."""
    F = omega.shape[-1]
    n = 2 * (F - 1)
    m = (torch.arange(F, dtype=torch.int64, device=omega.device) * D) & (n - 1)
    return _cis_neg((2.0 * math.pi / n) * m.to(torch.float32))


def _freeverb_channel_response(omega, sr, feedback, damp, spread: int):
    """(B, F) wet response of 8 damped combs -> 4 allpasses; feedback and
    damp (B, 1)."""
    z1 = torch.exp(-1j * omega)
    comb_sum = None
    for tune in _COMB_TUNINGS:
        zD = _static_lag_z(omega, int(sr * (tune + spread) / 44100.0))
        one_pole = 1.0 - damp * z1
        comb = zD * one_pole / (one_pole - feedback * (1.0 - damp) * zD)
        comb_sum = comb if comb_sum is None else comb_sum + comb
    ap = None
    for tune in _ALLPASS_TUNINGS:
        zD = _static_lag_z(omega, int(sr * (tune + spread) / 44100.0))
        a = (1.5 * zD - 1.0) / (1.0 - 0.5 * zD)
        ap = a if ap is None else ap * a
    return comb_sum * ap


def freeverb_response(p: dict, omega, sr: float, channels: int):
    def col(v):
        return torch.as_tensor(v, device=omega.device)[..., None]

    room, damping = col(p["room_size"]), col(p["damping"])
    wet_dry, width = col(p["wet_dry"]), col(p["width"])
    feedback = room * 0.28 + 0.7
    damp = damping * 0.4
    gain_in = 0.015
    dry = (1.0 - wet_dry) * 2.0

    H_L = _freeverb_channel_response(omega, sr, feedback, damp, 0)
    if channels == 1:
        return ("scalar", dry + 3.0 * wet_dry * gain_in * H_L)
    H_R = _freeverb_channel_response(omega, sr, feedback, damp,
                                     _STEREO_SPREAD)
    wet1 = 0.5 * wet_dry * 3.0 * (1.0 + width)
    wet2 = 0.5 * wet_dry * 3.0 * (1.0 - width)
    M_L = (wet1 * H_L + wet2 * H_R) * gain_in  # applied to (x_L + x_R)
    M_R = (wet1 * H_R + wet2 * H_L) * gain_in
    return ("monomix", (dry.to(torch.complex64), M_L, M_R))


def _to_matrix(kind, H, F: int):
    """A response as its (B, 2, 2, F) matrix."""
    if kind == "matrix":
        return H
    if kind == "monomix":
        D, GL, GR = H
        ones = torch.ones(F, dtype=torch.complex64, device=D.device)
        return torch.stack([
            torch.stack([(D + GL) * ones, GL * ones], dim=-2),
            torch.stack([GR * ones, (D + GR) * ones], dim=-2)], dim=-3)
    eye = torch.eye(2, dtype=torch.complex64, device=H.device)[None, :, :, None]
    return (H * torch.ones(F, dtype=torch.complex64, device=H.device))[
        :, None, None, :] * eye


def bypass_blend(kind, H, active):
    """Blend toward the identity response where ``active`` (B,) is False."""
    act = torch.as_tensor(active, dtype=torch.bool)
    one = torch.ones((), dtype=torch.complex64, device=act.device)
    if kind == "scalar":
        return torch.where(act[:, None], H, one)
    if kind == "monomix":
        D, GL, GR = H
        zero = torch.zeros_like(one)
        return (torch.where(act[:, None], D, one),
                torch.where(act[:, None], GL, zero),
                torch.where(act[:, None], GR, zero))
    eye = torch.eye(2, dtype=H.dtype, device=H.device)[None, :, :, None]
    return torch.where(act[:, None, None, None], H, eye)


def compose_responses(kind_old, H_old, kind_new, H_new, F: int):
    """The total response H_new . H_old (the new stage applied after)."""
    if H_old is None:
        return kind_new, H_new
    if kind_old == "scalar" and kind_new == "scalar":
        return "scalar", H_old * H_new
    if "matrix" not in (kind_old, kind_new):
        if kind_old == "scalar":  # a scalar commutes: scale the monomix
            D2, GL2, GR2 = H_new
            return "monomix", (H_old * D2, H_old * GL2, H_old * GR2)
        if kind_new == "scalar":
            D1, GL1, GR1 = H_old
            return "monomix", (D1 * H_new, GL1 * H_new, GR1 * H_new)
        # (D2 I + g2 1^T)(D1 I + g1 1^T)
        #   = D1 D2 I + (D2 g1 + (D1 + 1^T g1) g2) 1^T
        D1, GL1, GR1 = H_old
        D2, GL2, GR2 = H_new
        s1 = D1 + GL1 + GR1
        return "monomix", (D1 * D2, D2 * GL1 + s1 * GL2, D2 * GR1 + s1 * GR2)
    return "matrix", torch.einsum("bijf,bjkf->bikf",
                                  _to_matrix(kind_new, H_new, F),
                                  _to_matrix(kind_old, H_old, F))


def apply_response(kind, H, X):
    """A composed response applied to the spectrum X (B, C, F)."""
    if kind == "scalar":
        return X * H[:, None, :]
    if kind == "monomix":
        D, GL, GR = H
        Xs = X[:, 0, :] + X[:, 1, :]  # the mono sum (B, F)
        G = torch.stack([GL * torch.ones_like(Xs), GR * torch.ones_like(Xs)],
                        dim=1)
        return D[:, None, :] * X + G * Xs[:, None, :]
    return torch.einsum("bijf,bjf->bif", H, X)
