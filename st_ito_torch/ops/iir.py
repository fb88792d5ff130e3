"""Biquad design and application — port of ``st_ito_tpu/ops/iir.py``:
``biquad_coeffs`` (RBJ Audio-EQ cookbook, all eight forms of the JAX list),
``freqz`` / ``fft_filt`` / ``apply_iir_fsm`` (a cascade applied by
frequency sampling), the exact per-sample filters ``biquad_scan`` and
``lfilter_scan`` (plain loops over T: golden tests only),
``linear_recurrence``, ``one_pole_smooth`` and ``next_pow2``."""

from __future__ import annotations

import math

import torch

_FILTER_TYPES = ("low_shelf", "high_shelf", "peaking", "lowpass", "highpass",
                 "bandpass", "notch", "allpass")


def biquad_coeffs(gain_db, cutoff_freq, q_factor, sample_rate: float,
                  filter_type: str):
    """RBJ cookbook biquad. Returns (b, a), each shape (..., 3),
    a0-normalized, float32. Inputs broadcast against each other; plain
    numbers join the device of the tensors among them."""
    if filter_type not in _FILTER_TYPES:
        raise ValueError(f"Invalid filter_type: {filter_type}")
    dev = next((v.device for v in (gain_db, cutoff_freq, q_factor)
                if isinstance(v, torch.Tensor)), None)
    gain_db, cutoff_freq, q_factor = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev)
          for v in (gain_db, cutoff_freq, q_factor)))

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
    elif filter_type == "peaking":
        b0 = 1 + alpha * A
        b1 = -2 * cos_w0
        b2 = 1 - alpha * A
        a0 = 1 + alpha / A
        a1 = -2 * cos_w0
        a2 = 1 - alpha / A
    elif filter_type == "lowpass":
        b0 = (1 - cos_w0) / 2
        b1 = 1 - cos_w0
        b2 = (1 - cos_w0) / 2
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha
    elif filter_type == "highpass":
        b0 = (1 + cos_w0) / 2
        b1 = -(1 + cos_w0)
        b2 = (1 + cos_w0) / 2
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha
    elif filter_type == "bandpass":
        b0 = alpha
        b1 = torch.zeros_like(alpha)
        b2 = -alpha
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha
    elif filter_type == "notch":
        b0 = torch.ones_like(alpha)
        b1 = -2 * cos_w0
        b2 = torch.ones_like(alpha)
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha
    else:  # allpass
        b0 = 1 - alpha
        b1 = -2 * cos_w0
        b2 = 1 + alpha
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha

    b = torch.stack([b0, b1, b2], dim=-1) / a0[..., None]
    a = torch.stack([a0, a1, a2], dim=-1) / a0[..., None]
    return b, a


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# Frequency-sampling application
# --------------------------------------------------------------------------


def _eval_biquad_poly(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      floor_sum: bool) -> torch.Tensor:
    """c0 + c1 z^-1 + c2 z^-2 on the unit circle, written as
    S - c1*(1 - z^-1) - c2*(1 - z^-2) with S = c0 + c1 + c2: near w = 0 the
    direct sum cancels catastrophically in float32 for low-frequency high-Q
    biquads. All cancellation stays inside S, which (for denominators) is
    floored away from exact zero."""
    S = c[..., 0] + c[..., 1] + c[..., 2]
    if floor_sum:
        eps = 1e-7 * (c[..., 0].abs() + c[..., 1].abs() + c[..., 2].abs())
        S = torch.where(S.abs() < eps, eps, S)
    return (S[..., None].to(torch.complex64)
            - c[..., 1:2].to(torch.complex64) * u
            - c[..., 2:3].to(torch.complex64) * v)


def _unit_circle_uv(w: torch.Tensor):
    """u = 1 - e^{-jw}, v = 1 - e^{-j2w} in their half-angle forms (no
    1 - cos cancellation)."""
    sh, ch = torch.sin(w / 2.0), torch.cos(w / 2.0)
    u = torch.complex(2.0 * sh * sh, 2.0 * sh * ch)
    sw, cw = torch.sin(w), torch.cos(w)
    v = torch.complex(2.0 * sw * sw, 2.0 * sw * cw)
    return u, v


def freqz(b: torch.Tensor, a: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Complex frequency response of IIR sections on the rFFT grid of size
    ``2*(n_freqs-1)``. b, a: (..., K) coefficients; second-order sections
    (K = 3) use the cancellation-stable evaluation, higher orders the direct
    polynomial sum. Returns (..., n_freqs) complex64."""
    w = torch.linspace(0.0, math.pi, n_freqs, dtype=torch.float32,
                       device=b.device)
    if b.shape[-1] == 3 and a.shape[-1] == 3:
        u, v = _unit_circle_uv(w)
        return (_eval_biquad_poly(b, u, v, floor_sum=False)
                / _eval_biquad_poly(a, u, v, floor_sum=True))
    k = torch.arange(b.shape[-1], dtype=torch.float32, device=b.device)
    ang = w[:, None] * k[None, :]
    zk = torch.complex(torch.cos(ang), -torch.sin(ang))  # (n_freqs, K)
    num = torch.einsum("...k,fk->...f", b.to(torch.complex64), zk)
    den = torch.einsum("...k,fk->...f", a.to(torch.complex64), zk)
    return num / den


def fft_filt(x: torch.Tensor, H: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Apply a response H (on the size-``fft_size`` rFFT grid) to x along
    the last axis: x is zero-padded to fft_size, the output cropped to
    x.shape[-1]."""
    T = x.shape[-1]
    X = torch.fft.rfft(x, n=fft_size, dim=-1)
    return torch.fft.irfft(X * H, n=fft_size, dim=-1)[..., :T].to(x.dtype)


def apply_iir_fsm(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
                  pad: int = 8192) -> torch.Tensor:
    """Apply a cascade of IIR sections by frequency sampling. x: (..., T);
    b, a: (..., S, 3), the S sections multiplied into one response; their
    leading dims broadcast against x's. ``pad`` is the headroom for the
    impulse-response tail (the circular-wrap guard)."""
    n = next_pow2(x.shape[-1] + pad)
    H = torch.prod(freqz(b, a, n // 2 + 1), dim=-2)
    return fft_filt(x, H, n)


def biquad_scan(x: torch.Tensor, b: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """Exact TDF-II biquad over the last axis (scipy.signal.lfilter(b, a,
    x) for a second-order section, a0 = 1); b, a (..., 3) broadcast
    against x's leading dims. A loop over T: golden tests only."""
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    a1, a2 = a[..., 1], a[..., 2]
    s1 = s2 = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    out = []
    for xt in x.unbind(-1):
        yt = b0 * xt + s1
        s1, s2 = b1 * xt - a1 * yt + s2, b2 * xt - a2 * yt
        out.append(yt)
    return torch.stack(out, dim=-1)


def lfilter_scan(x: torch.Tensor, b: torch.Tensor,
                 a: torch.Tensor) -> torch.Tensor:
    """Exact direct-form-II-transposed filter of any order over the last
    axis (scipy.signal.lfilter semantics); b, a (K,) with a[0] == 1. A loop
    over T: golden tests only."""
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    K = b.shape[0]
    if K == 3:
        return biquad_scan(x, b, a)
    zero = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    state = [zero] * (K - 1)
    out = []
    for xt in x.unbind(-1):
        yt = b[0] * xt + state[0]
        state = [b[i] * xt - a[i] * yt + (state[i] if i < K - 1 else zero)
                 for i in range(1, K)]
        out.append(yt)
    return torch.stack(out, dim=-1)


# --------------------------------------------------------------------------
# First-order linear recurrences (parallel prefix)
# --------------------------------------------------------------------------


def doubling_scan(combine, elems: tuple, dim: int = -1) -> tuple:
    """Inclusive prefix scan of an associative ``combine(earlier, later)``
    over tuples of equally shaped tensors, by log-step doubling along
    ``dim``: ceil(log2 T) steps of whole-tensor ops (18 at T = 262144),
    never a loop over T. Stands in for ``jax.lax.associative_scan``."""
    T = elems[0].shape[dim]
    d = 1
    while d < T:
        earlier = tuple(e.narrow(dim, 0, T - d) for e in elems)
        later = tuple(e.narrow(dim, d, T - d) for e in elems)
        merged = combine(earlier, later)
        elems = tuple(torch.cat([e.narrow(dim, 0, d), m], dim=dim)
                      for e, m in zip(elems, merged))
        d *= 2
    return elems


def linear_recurrence(coeff: torch.Tensor, drive: torch.Tensor,
                      axis: int = -1) -> torch.Tensor:
    """Solve y[n] = coeff[n] * y[n-1] + drive[n] (y[-1] = 0) in parallel:
    elements (a, b) compose as (a2*a1, a2*b1 + b2)."""

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 * a2, a2 * b1 + b2

    coeff, drive = torch.broadcast_tensors(coeff, drive)
    return doubling_scan(combine, (coeff, drive), dim=axis)[1]


def one_pole_smooth(x: torch.Tensor, alpha, axis: int = -1) -> torch.Tensor:
    """One-pole lowpass y[n] = alpha*y[n-1] + (1-alpha)*x[n] from rest;
    alpha a scalar or elementwise (time-varying ballistics)."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device).expand(
        x.shape)
    return linear_recurrence(alpha, (1.0 - alpha) * x, axis=axis)
