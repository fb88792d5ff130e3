"""STFT, spectrogram, mel, log-mel and MFCC with torchlibrosa / librosa /
torchaudio parity — port of ``st_ito_tpu/ops/stft.py``: the window, the
framing, ``stft``, ``spectrogram``, the Slaney and HTK mel filterbanks,
``power_to_db``, ``logmel``, ``_dct_matrix``, ``mfcc`` and
``spectral_centroid``. The mel and DCT matrices are built in float64 numpy
and cast to float32, exactly as the JAX package does."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from st_ito_torch.parallel.collectives import batch_max


def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic (fftbins=True) Hann window."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_fft) frames (a strided view). With
    ``center`` the signal is reflect-padded by n_fft//2 on both sides
    first (librosa / torchlibrosa), and n_frames = T // hop + 1."""
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(*lead, -1)
    return x.unfold(-1, n_fft, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, center: bool = True,
         window=None) -> torch.Tensor:
    """Complex STFT: (..., T) -> (..., n_frames, n_fft//2 + 1)."""
    if window is None:
        window = hann_window(n_fft, x.device)
    frames = frame_signal(x, n_fft, hop, center=center)
    return torch.fft.rfft(frames * window, dim=-1)


def spectrogram(x: torch.Tensor, n_fft: int, hop: int, power: float = 2.0,
                center: bool = True) -> torch.Tensor:
    """Magnitude-power spectrogram (torchlibrosa Spectrogram parity)."""
    S = torch.abs(stft(x, n_fft, hop, center=center))
    if power != 1.0:
        S = S ** power
    return S


_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_np(f, htk: bool = False):
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    with np.errstate(divide="ignore"):  # f=0 takes the linear branch
        return np.where(f >= _MIN_LOG_HZ,
                        _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP,
                        f / _F_SP)


def _mel_to_hz_np(m, htk: bool = False):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    m * _F_SP)


def mel_filterbank(sample_rate: float, n_fft: int, n_mels: int, fmin: float,
                   fmax: float, htk: bool = False,
                   norm: str | None = "slaney") -> torch.Tensor:
    """(n_fft//2+1, n_mels) mel matrix. The defaults are
    librosa.filters.mel's (Slaney scale and area norm, what torchlibrosa's
    LogmelFilterBank holds); htk=True with norm=None are torchaudio's (the
    MFCC metric's)."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_np(fmin, htk), _hz_to_mel_np(fmax, htk),
                          n_mels + 2)
    f_pts = _mel_to_hz_np(mel_pts, htk)
    fdiff = np.diff(f_pts)
    slopes = f_pts[None, :] - fftfreqs[:, None]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    weights = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        weights = weights * (2.0 / (f_pts[2:n_mels + 2]
                                    - f_pts[:n_mels]))[None]
    return torch.as_tensor(weights.astype(np.float32))


def power_to_db(S: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = None) -> torch.Tensor:
    """10 log10(max(S, amin) / ref); with ``top_db`` floored at the
    maximum over the whole tensor less top_db, as the JAX package takes
    it (over the global batch inside a mesh's ``sharded`` scope)."""
    log_spec = (10.0 * torch.log10(torch.clamp_min(S, amin))
                - 10.0 * math.log10(max(amin, ref)))
    if top_db is not None:
        top = batch_max(log_spec.max())
        log_spec = torch.maximum(log_spec, top - top_db)
    return log_spec


def logmel(x: torch.Tensor, sample_rate: float, n_fft: int = 2048,
           hop: int = 1024, n_mels: int = 128, fmin: float = 20.0,
           fmax: float = 20000.0, mel_matrix=None) -> torch.Tensor:
    """torchlibrosa-parity log-mel: (..., T) -> (..., n_frames, n_mels)."""
    S = spectrogram(x, n_fft, hop, power=2.0, center=True)
    if mel_matrix is None:
        mel_matrix = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return power_to_db(S @ mel_matrix.to(S.device), ref=1.0, amin=1e-10)


def _dct_matrix(n_mfcc: int, n_mels: int) -> torch.Tensor:
    """DCT-II with ortho norm, (n_mels, n_mfcc)."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * np.sqrt(
        2.0 / n_mels)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return torch.as_tensor(dct.astype(np.float32))


def mfcc(x: torch.Tensor, sample_rate: float = 48000, n_mfcc: int = 25,
         n_fft: int = 2048, hop: int = 1024, n_mels: int = 128,
         center: bool = False) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_mfcc), torchaudio.transforms.MFCC
    semantics: HTK mel without norm, power to dB (top_db 80), ortho
    DCT-II."""
    S = spectrogram(x, n_fft, hop, power=2.0, center=center)
    W = mel_filterbank(sample_rate, n_fft, n_mels, 0.0, sample_rate / 2.0,
                       htk=True, norm=None).to(S.device)
    mel_db = power_to_db(S @ W, ref=1.0, amin=1e-10, top_db=80.0)
    return mel_db @ _dct_matrix(n_mfcc, n_mels).to(S.device)


def spectral_centroid(x: torch.Tensor, sample_rate: float, n_fft: int = 2048,
                      hop: int = 1024) -> torch.Tensor:
    """Per-frame spectral centroid in Hz: (..., T) -> (..., n_frames)."""
    S = torch.abs(stft(x, n_fft, hop))
    freqs = torch.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1,
                           device=x.device)
    return (torch.sum(S * freqs, dim=-1)
            / torch.clamp_min(torch.sum(S, dim=-1), 1e-8))
