"""Bandlimited resampling by FFT — port of ``st_ito_tpu/ops/resample.py``:
exact sinc interpolation of the periodic extension, one ``torch.fft`` pair.
Against a windowed-sinc FIR it differs only in the first and last few
samples of an audio-length signal."""

from __future__ import annotations

import torch


def resample(x: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """Resample along the last axis. Output length round(T * new/orig)."""
    if orig_sr == new_sr:
        return x
    T = x.shape[-1]
    T_new = int(round(T * new_sr / orig_sr))
    X = torch.fft.rfft(x, dim=-1)
    n_in = X.shape[-1]
    n_out = T_new // 2 + 1
    if n_out <= n_in:
        Xr = X[..., :n_out].clone()
        # zero the (possibly shared) Nyquist bin's imaginary part when
        # truncating
        if T_new % 2 == 0:
            Xr[..., -1] = Xr[..., -1].real.to(Xr.dtype)
    else:
        Xr = torch.nn.functional.pad(X, (0, n_out - n_in))
    y = torch.fft.irfft(Xr, n=T_new, dim=-1) * (T_new / T)
    return y.to(x.dtype)
