"""The compressor, the limiter and the noise gate — port of
``st_ito_tpu/ops/dynamics.py``'s ``_time_constant_alpha``, ``gain_computer``
(the fused K1 and K7 kernels inline the same gain computer per sample),
``ballistics_parallel``, ``ballistics`` (K8 when ``fast``),
``ballistics_scan``, ``compressor`` (K7 when fast and unlinked),
``limiter`` and ``noise_gate`` (its detector in K8 when ``fast``).

The attack/release ballistics are the decoupled peak detector (Giannoulis,
Massberg & Reiss 2012). Its release stage is a min-affine recurrence, closed
under composition, so it evaluates exactly as a parallel prefix scan; the
attack stage is an LTI one-pole. ``fast=True`` (the population renderer)
runs a fast, unlinked compressor without lookahead as one pass of K7
(``ops/kernels/scan.py compressor_fused``), and the detector of any other
fast compressor through K8, the rest op by op. On a CPU tensor both kernels'
plain versions stand in for them."""

from __future__ import annotations

import torch

from st_ito_torch.ops.iir import doubling_scan, linear_recurrence
from st_ito_torch.ops.kernels import scan as _scan


def _time_constant_alpha(time_ms, sample_rate: float) -> torch.Tensor:
    """One-pole smoothing coefficient for a given time constant: the
    exponent in float32, its exp in float64 rounded once to float32. At
    release times of a second alpha lies within 2e-5 of 1, where one ulp
    of it is 0.3% of 1 - alpha, the detector's rate, and the gradients of
    gradient ITO follow it closely; the float32 exps of the CPU and the
    card differ by an ulp on some arguments. Rounded once, alpha is the
    same on both."""
    time_ms = torch.clamp_min(torch.as_tensor(time_ms, dtype=torch.float32),
                              1e-3)
    exponent = -1.0 / (time_ms * 0.001 * sample_rate)
    return torch.exp(exponent.to(torch.float64)).to(torch.float32)


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


def _lead_coeff(alpha, like: torch.Tensor) -> torch.Tensor:
    """A per-lead coefficient broadcast over the time axis of ``like``."""
    alpha = torch.as_tensor(alpha, dtype=like.dtype, device=like.device)
    if alpha.ndim == like.ndim - 1:
        alpha = alpha[..., None]
    return alpha.expand(like.shape)


def ballistics_parallel(c: torch.Tensor, alpha_attack, alpha_release,
                        axis: int = -1) -> torch.Tensor:
    """Decoupled attack/release detector, exact parallel form.

    Stage 1 (release, instant downward tracking):
        y1[n] = min(c[n], ar*y1[n-1] + (1-ar)*c[n])
    Each step is the min-affine map f_n(y) = min(c_n, ar*y + b_n); (k, b, m)
    with f(y) = min(m, k*y + b) composes as
    (k2*k1, k2*b1 + b2, min(m2, k2*m1 + b2)), so the recurrence is one
    doubling scan. Stage 2 (attack): one-pole smoothing with the attack
    coefficient. c is the gain computer's output in dB (<= 0), time on the
    last axis."""
    if axis not in (-1, c.ndim - 1):
        raise ValueError("ballistics_parallel scans the last axis")
    k = _lead_coeff(alpha_release, c)
    b = (1.0 - k) * c

    def combine(e1, e2):
        k1, b1, m1 = e1
        k2, b2, m2 = e2
        return k1 * k2, k2 * b1 + b2, torch.minimum(m2, k2 * m1 + b2)

    _, B, M = doubling_scan(combine, (k, b, c), dim=-1)
    y1 = torch.minimum(M, B)  # initial state y1[-1] = 0

    aa = _lead_coeff(alpha_attack, c)
    return linear_recurrence(aa, (1.0 - aa) * y1, axis=-1)


def ballistics(c: torch.Tensor, alpha_attack, alpha_release,
               fast: bool = False) -> torch.Tensor:
    """The decoupled detector over the last axis of c (..., T): K8 when
    ``fast`` (its plain version on a CPU tensor), else the parallel form."""
    if fast:
        return _scan.ballistics(c, alpha_attack, alpha_release)
    return ballistics_parallel(c, alpha_attack, alpha_release)


def ballistics_scan(c: torch.Tensor, alpha_attack, alpha_release):
    """Serial per-sample reference of the same detector, K8's plain version
    on any device (a Python loop over T: tests and ``exact_ballistics``
    only). Returns c's shape, float32."""
    c_in, vec, _ = _scan.ballistics_inputs(c, alpha_attack, alpha_release)
    return _scan.ballistics_plain(c_in, vec).reshape(c.shape)


def compressor(x: torch.Tensor, sample_rate: float, threshold_db=-20.0,
               ratio=4.0, attack_ms=10.0, release_ms=100.0, knee_db=6.0,
               makeup_gain_db=0.0, lookahead_samples: int = 0,
               link_channels: bool = True, exact_ballistics: bool = False,
               fast: bool = False, active=None) -> torch.Tensor:
    """Feed-forward compressor on x of shape (..., C, T).

    Detection: peak of |x|, linked over channels or per channel.
    ``fast=True`` runs a compressor that is unlinked, has no lookahead and
    no ``exact_ballistics`` as one pass of K7 (its plain version on a CPU
    tensor), as the JAX package does on the TPU; any other fast compressor
    runs op by op with its ballistics in K8.
    ``active``: optional per-item float bypass mask broadcastable to the
    leading dims (1.0 = effect on), blended in-kernel on the K7 path and
    arithmetically otherwise."""
    dev = x.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    x_in = x  # the dry signal before the lookahead, for the bypass blend
    alpha_a = _time_constant_alpha(f32(attack_ms), sample_rate)
    alpha_r = _time_constant_alpha(f32(release_ms), sample_rate)
    if (fast and not link_channels and lookahead_samples == 0
            and not exact_ballistics):
        # the whole compressor as one pass (unlinked: the detector is per
        # lane), the JAX package's dispatch (st_ito_tpu/ops/dynamics.py:171)
        lead = tuple(x.shape[:-1])

        def to_lead(v):
            v = f32(v)
            while v.ndim > len(lead):  # drop broadcast T axes like (B,1,1)
                v = v[..., 0]
            return v.expand(lead)

        return _scan.compressor_fused(
            x, to_lead(threshold_db), to_lead(ratio), to_lead(knee_db),
            to_lead(alpha_a), to_lead(alpha_r), to_lead(makeup_gain_db),
            active=None if active is None else to_lead(active))
    if link_channels:
        env = x.abs().amax(dim=-2, keepdim=True)  # (..., 1, T)
    else:
        env = x.abs()
    env_db = 20.0 * torch.log10(torch.clamp_min(env, 1e-8))

    gr_db = gain_computer(env_db, f32(threshold_db), f32(ratio), f32(knee_db))

    aa = alpha_a.expand(gr_db.shape)[..., 0]
    ar = alpha_r.expand(gr_db.shape)[..., 0]
    if exact_ballistics:
        gr_smooth = ballistics_scan(gr_db, aa, ar)
    else:
        gr_smooth = ballistics(gr_db, aa, ar, fast=fast)

    gain = 10.0 ** (gr_smooth / 20.0)

    if lookahead_samples > 0:
        # delay the audio so the gain anticipates transients
        x = torch.nn.functional.pad(x, (lookahead_samples, 0))[
            ..., :x.shape[-1]]

    y = x * gain
    y = y * 10.0 ** (f32(makeup_gain_db) / 20.0)
    if active is not None:
        act = f32(active)
        while act.ndim < y.ndim:
            act = act[..., None]
        y = act * y + (1.0 - act) * x_in
    return y


def limiter(x: torch.Tensor, sample_rate: float, threshold_db=-1.0,
            release_ms=100.0, fast: bool = False) -> torch.Tensor:
    """Brickwall-style limiter: a linked high-ratio fast-attack compressor
    (pedalboard.Limiter semantics: threshold and release only)."""
    return compressor(x, sample_rate, threshold_db=threshold_db, ratio=1000.0,
                      attack_ms=0.05, release_ms=release_ms, knee_db=0.1,
                      makeup_gain_db=0.0, fast=fast)


def noise_gate(x: torch.Tensor, sample_rate: float, threshold_db=-60.0,
               ratio=10.0, attack_ms=1.0, release_ms=100.0,
               fast: bool = False) -> torch.Tensor:
    """Downward expander (pedalboard.NoiseGate-style) on x (..., C, T):
    the envelope is the peak over channels; below the threshold the level
    is expanded by ``ratio``, floored at -100 dB, and smoothed by the
    decoupled detector: K8 when ``fast`` (its plain version on a CPU
    tensor), else the parallel form. The parameters broadcast to x's
    leading dims."""
    dev = x.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    env = x.abs().amax(dim=-2, keepdim=True)  # (..., 1, T)
    env_db = 20.0 * torch.log10(torch.clamp_min(env, 1e-8))
    under = torch.clamp_max(env_db - f32(threshold_db), 0.0)
    gr_db = torch.clamp_min(under * (f32(ratio) - 1.0), -100.0)
    alpha_a = _time_constant_alpha(f32(attack_ms), sample_rate)
    alpha_r = _time_constant_alpha(f32(release_ms), sample_rate)
    # the gate opens (gain rising) at its attack time and closes at its
    # release time: the detector's attack slot takes the release
    # coefficient and its release slot the attack's, as in the JAX package
    # (st_ito_tpu/ops/dynamics.py:265)
    gr_smooth = ballistics(gr_db, alpha_r.expand(gr_db.shape)[..., 0],
                           alpha_a.expand(gr_db.shape)[..., 0], fast=fast)
    return x * 10.0 ** (gr_smooth / 20.0)
