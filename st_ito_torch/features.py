"""Hand-crafted style features — port of ``st_ito_tpu/features.py``: the
Bark-band spectrum, RMS energy, crest factor, LUFS (``ops/loudness.py``)
and the pooled spectral centroid, the MIR feature metric
(``get_mir_feature_embeds`` / ``load_mir_feature_extractor``). All batched
over the leading dim, on x's device."""

from __future__ import annotations

import numpy as np
import torch

from st_ito_torch.models.registry import _l2_normalize
from st_ito_torch.ops.loudness import integrated_loudness
from st_ito_torch.ops.stft import stft as _stft


def _hz_to_bark_np(f, bark_scale: str = "traunmuller"):
    f = np.asarray(f, np.float64)
    if bark_scale == "wang":
        return 6.0 * np.arcsinh(f / 600.0)
    if bark_scale == "schroeder":
        return 7.0 * np.arcsinh(f / 650.0)
    barks = (26.81 * f) / (1960.0 + f) - 0.53
    barks = np.where(barks < 2.0, barks + 0.15 * (2.0 - barks), barks)
    return np.where(barks > 20.1, barks + 0.22 * (barks - 20.1), barks)


def _bark_to_hz_np(barks, bark_scale: str = "traunmuller"):
    barks = np.asarray(barks, np.float64).copy()
    if bark_scale == "wang":
        return 600.0 * np.sinh(barks / 6.0)
    if bark_scale == "schroeder":
        return 650.0 * np.sinh(barks / 7.0)
    barks = np.where(barks < 2.0, (barks - 0.3) / 0.85, barks)
    barks = np.where(barks > 20.1, (barks + 4.422) / 1.22, barks)
    return 1960.0 * ((barks + 0.53) / (26.28 - barks))


def barkscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_barks: int,
                     sample_rate: int,
                     bark_scale: str = "traunmuller") -> torch.Tensor:
    """(n_freqs, n_barks) triangular Bark filterbank, built in float64
    numpy and cast to float32."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_bark_np(f_min, bark_scale),
                        _hz_to_bark_np(f_max, bark_scale), n_barks + 2)
    f_pts = _bark_to_hz_np(m_pts, bark_scale)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return torch.as_tensor(fb.astype(np.float32))


def compute_barkspectrum(x: torch.Tensor, fft_size: int = 32768,
                         n_bands: int = 24, sample_rate: int = 44100,
                         f_min: float = 20.0, f_max: float = 20000.0,
                         mode: str = "mid-side", **kwargs) -> torch.Tensor:
    """x (bs, 2, T) -> L2-normalised (bs, n_bands * signals): the log Bark
    spectrum of the time-averaged rectangular-window STFT magnitude."""
    fb = barkscale_fbanks(fft_size // 2 + 1, f_min, f_max, n_bands,
                          sample_rate).to(x.device)
    if mode == "mono":
        signals = [x.mean(dim=1)]
    elif mode == "stereo":
        signals = [x[:, 0, :], x[:, 1, :]]
    elif mode == "mid-side":
        signals = [x[:, 0, :] + x[:, 1, :], x[:, 0, :] - x[:, 1, :]]
    else:
        raise ValueError(f"Invalid mode {mode}")
    rect = torch.ones(fft_size, device=x.device)
    outs = []
    for sig in signals:
        X = torch.abs(_stft(sig, fft_size, fft_size // 4, window=rect))
        X = X.mean(dim=-2)  # over time -> (bs, freqs)
        outs.append(torch.log(X @ fb + 1e-8))
    return _l2_normalize(torch.cat(outs, dim=-1))


def compute_rms_energy(x: torch.Tensor, **kwargs) -> torch.Tensor:
    """(bs, chs, T) -> (bs, chs)."""
    return torch.sqrt(torch.clamp_min(torch.mean(x ** 2, dim=-1), 1e-8))


def compute_crest_factor(x: torch.Tensor, **kwargs) -> torch.Tensor:
    """Peak over RMS in dB per channel, (bs, chs); scale-invariant, so not
    normalised first (the JAX package's choice, st_ito_tpu/features.py)."""
    num = x.abs().amax(dim=-1)
    den = compute_rms_energy(x)
    return 20.0 * torch.log10(torch.clamp_min(
        num / torch.clamp_min(den, 1e-8), 1e-8))


def compute_lufs(x: torch.Tensor, sample_rate: float,
                 **kwargs) -> torch.Tensor:
    """(bs, chs, T) -> (bs, 1) integrated LUFS, each sample normalised by
    its peak over the channels first, as the JAX package does."""
    peak = x.abs().amax(dim=1, keepdim=True)
    x = x / torch.clamp_min(peak, 1e-8)
    if x.shape[1] < 2:
        x = x.repeat_interleave(2, dim=1)
    return integrated_loudness(x, sample_rate)[:, None]


def compute_spectral_centroid(x: torch.Tensor, sample_rate: float,
                              n_fft: int = 2048, hop: int = 1024,
                              num_pooled: int = 10,
                              **kwargs) -> torch.Tensor:
    """(bs, chs, T) -> (bs, chs * num_pooled): the per-frame centroid,
    adaptive-average-pooled over frames, over the Nyquist frequency."""
    S = torch.abs(_stft(x, n_fft, hop))  # (bs, chs, frames, freqs)
    freqs = torch.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1,
                           device=x.device)
    sc = torch.sum(S * freqs, dim=-1) / torch.clamp_min(
        torch.sum(S, dim=-1), 1e-8)
    sc = torch.nan_to_num(sc)
    bs, chs, F = sc.shape
    # adaptive average pool: bin i covers [floor(i F / n), ceil((i+1) F / n))
    pooled = []
    for i in range(num_pooled):
        s = (i * F) // num_pooled
        e = max(-(-((i + 1) * F) // num_pooled), s + 1)
        pooled.append(sc[..., s:e].mean(dim=-1))
    sc = torch.stack(pooled, dim=-1).reshape(bs, -1)
    return sc / (sample_rate / 2.0)


def get_mir_feature_embeds(x: torch.Tensor, model, sample_rate,
                           **kwargs) -> dict[str, torch.Tensor]:
    """The MIR feature dict of x (bs, chs, T): lufs, rms, crest, the mono
    Bark spectrum and the pooled spectral centroid."""
    sample_rate = int(sample_rate)
    return {
        "lufs": compute_lufs(x, sample_rate),
        "rms": compute_rms_energy(x),
        "crest": compute_crest_factor(x),
        "barkspectrum": compute_barkspectrum(x, sample_rate=sample_rate,
                                             mode="mono"),
        "spectral_centroid": compute_spectral_centroid(x, sample_rate),
    }


class _MIRModel:
    embed_dim = 49


def load_mir_feature_extractor(use_gpu: bool = False) -> _MIRModel:
    return _MIRModel()
