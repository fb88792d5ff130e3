"""Window, framing, Slaney mel filterbank and power-to-dB with torchlibrosa /
librosa parity — port of the parts of ``st_ito_tpu/ops/stft.py`` the Cnn14
front end uses. The mel matrix is built in float64 numpy and cast to
float32, exactly as the JAX package does."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> torch.Tensor:
    """Periodic (fftbins=True) Hann window."""
    k = torch.arange(n, dtype=torch.float32)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(N, T) -> (N, n_frames, n_fft) frames of the signal reflect-padded
    by n_fft//2 on both sides (a strided view); n_frames = T // hop + 1."""
    x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    return x.unfold(-1, n_fft, hop)


_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_np(f):
    """Slaney mel scale."""
    f = np.asarray(f, np.float64)
    with np.errstate(divide="ignore"):  # f=0 takes the linear branch
        return np.where(f >= _MIN_LOG_HZ,
                        _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP,
                        f / _F_SP)


def _mel_to_hz_np(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    m * _F_SP)


def mel_filterbank(sample_rate: float, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> torch.Tensor:
    """(n_fft//2+1, n_mels) mel matrix = librosa.filters.mel defaults
    (Slaney scale + Slaney area norm)."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_np(fmin), _hz_to_mel_np(fmax),
                          n_mels + 2)
    f_pts = _mel_to_hz_np(mel_pts)
    fdiff = np.diff(f_pts)
    slopes = f_pts[None, :] - fftfreqs[:, None]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    weights = np.maximum(0.0, np.minimum(down, up))
    weights = weights * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None]
    return torch.as_tensor(weights.astype(np.float32))


def power_to_db(S: torch.Tensor, ref: float = 1.0,
                amin: float = 1e-10) -> torch.Tensor:
    return (10.0 * torch.log10(torch.clamp_min(S, amin))
            - 10.0 * math.log10(max(amin, ref)))
