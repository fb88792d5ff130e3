"""Audio losses — port of ``st_ito_tpu/ops/losses.py``: the
multi-resolution STFT loss with auraloss's defaults (FFT sizes 1024, 2048,
512; hops 120, 240, 50; windows 600, 1200, 240), each resolution's loss
the spectral convergence plus the log-magnitude L1, averaged. Inside a
mesh's ``sharded`` scope both are the global batch's: the spectral
convergence's Frobenius norms and the L1's mean come from differentiable
all-reduces of the ranks' sums."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from st_ito_torch.ops.stft import frame_signal, hann_window
from st_ito_torch.parallel.collectives import active, all_reduce_sum


def _stft_mag(x: torch.Tensor, fft_size: int, hop: int,
              win_length: int) -> torch.Tensor:
    """Magnitude STFT with a centred win_length Hann window zero-padded to
    fft_size (torch.stft(win_length=...) as auraloss calls it)."""
    pad = (fft_size - win_length) // 2
    window = F.pad(hann_window(win_length, x.device),
                   (pad, fft_size - win_length - pad))
    frames = frame_signal(x, fft_size, hop, center=True)
    return torch.abs(torch.fft.rfft(frames * window, dim=-1))


def stft_loss(pred: torch.Tensor, target: torch.Tensor, fft_size: int,
              hop: int, win_length: int, w_sc: float = 1.0,
              w_log_mag: float = 1.0, eps: float = 1e-8) -> torch.Tensor:
    """One resolution: spectral convergence + log-magnitude L1."""
    P = _stft_mag(pred, fft_size, hop, win_length)
    T = _stft_mag(target, fft_size, hop, win_length)
    l1 = torch.abs(torch.log(T + eps) - torch.log(P + eps))
    mesh = active()
    if mesh is None:
        sc = torch.linalg.norm(T - P) / torch.clamp_min(torch.linalg.norm(T),
                                                         eps)
        log_mag = torch.mean(l1)
    else:
        sums = all_reduce_sum(torch.stack(
            [((T - P) ** 2).sum(), (T ** 2).sum(), l1.sum()]), mesh)
        sc = torch.sqrt(sums[0]) / torch.clamp_min(torch.sqrt(sums[1]), eps)
        log_mag = sums[2] / (l1.numel() * mesh.world_size)
    return w_sc * sc + w_log_mag * log_mag


def multi_resolution_stft_loss(
        pred: torch.Tensor, target: torch.Tensor,
        fft_sizes: tuple[int, ...] = (1024, 2048, 512),
        hop_sizes: tuple[int, ...] = (120, 240, 50),
        win_lengths: tuple[int, ...] = (600, 1200, 240)) -> torch.Tensor:
    """pred, target (..., T); the batch and channels fold into the mean."""
    pred = pred.reshape(-1, pred.shape[-1])
    target = target.reshape(-1, target.shape[-1])
    return torch.stack([stft_loss(pred, target, f, h, w) for f, h, w in
                        zip(fft_sizes, hop_sizes, win_lengths)]).mean()
