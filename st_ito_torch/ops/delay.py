"""Feedback delay — port of ``st_ito_tpu/ops/delay.py:25 feedback_delay``.

LTI for fixed delay and feedback: the wet response
H(w) = e^{-jwD} / (1 - fb e^{-jwD}) is applied by FFT with a guard of the
full signal length; a fractional D is exact in the phase term."""

from __future__ import annotations

import math

import torch

from st_ito_torch.ops.iir import next_pow2


def feedback_delay(x: torch.Tensor, sample_rate: float, delay_seconds,
                   feedback, mix) -> torch.Tensor:
    """y = (1-mix)*x + mix*wet, wet[n] = x[n-D] + fb*wet[n-D]; x (..., T),
    scalar parameters."""
    T = x.shape[-1]
    n = next_pow2(2 * T)
    F = n // 2 + 1
    dev = x.device

    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    D = scalar(delay_seconds) * sample_rate
    fb = scalar(feedback)
    mix = scalar(mix)

    w = torch.linspace(0.0, math.pi, F, dtype=torch.float32, device=dev)
    # exact integer phase reduction (k*Di) & (n-1), as chain/rp_responses.py
    # delay_build: the product is formed in int64, of which the JAX
    # package's wrapped int32 keeps the same low bits
    Di = torch.floor(D)
    Df = D - Di
    m = (torch.arange(F, dtype=torch.int64, device=dev)
         * Di.to(torch.int64)) & (n - 1)
    theta = (2.0 * math.pi / n) * m.to(torch.float32) + w * Df
    zD = torch.complex(torch.cos(theta), -torch.sin(theta))
    H = zD / (1.0 - fb * 0.999 * zD)  # 0.999 bounds the tail at fb = 1

    X = torch.fft.rfft(x, n=n, dim=-1)
    wet = torch.fft.irfft(X * H, n=n, dim=-1)[..., :T].to(x.dtype)
    return (1.0 - mix) * x + mix * wet
