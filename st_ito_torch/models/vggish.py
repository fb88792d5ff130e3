"""VGGish as an ``nn.Module`` — port of ``st_ito_tpu/models/vggish.py``
(upstream harritaylor/torchvggish, Hershey et al. 2017).

Pipeline (the upstream ``vggish_params`` constants): the waveform at
16 kHz -> a framed magnitude STFT (25 ms periodic Hann window, 10 ms hop,
n_fft 512, no centring) -> a 64-band HTK mel filterbank (125-7500 Hz) ->
log(mel + 0.01) -> non-overlapping 0.96 s examples of 96 frames, tails
dropped -> the VGG conv stack -> a 3-layer MLP -> a 128-d embedding per
example -> the mean over examples. Every example of a batch runs through
the conv stack as one batch.

The module's parameter names are the upstream ``state_dict``'s
(``features.{i}``, ``embeddings.{i}``); with the PCA postprocessor its two
tensors are buffers ``pca_eigen_vectors`` and ``pca_means``, the names of
the upstream ``vggish_pca_params`` file. It runs in float32 with cuDNN's
TF32 off. Embeddings are not normalised, as in the reference, whose
callers take cosines.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn as nn

from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.models.encoders import frozen, xavier_init_
from st_ito_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class VGGishConfig:
    sample_rate: int = 16000
    stft_win: int = 400  # 0.025 s
    stft_hop: int = 160  # 0.010 s
    n_fft: int = 512
    n_mels: int = 64
    mel_min_hz: float = 125.0
    mel_max_hz: float = 7500.0
    log_offset: float = 0.01
    example_frames: int = 96  # 0.96 s windows, hop == window
    embed_dim: int = 128


# conv plan: (layer index in the torch Sequential, in_c, out_c); "M" =
# a 2x2 max pool
_VGG_PLAN = [(0, 1, 64), "M", (3, 64, 128), "M", (6, 128, 256),
             (8, 256, 256), "M", (11, 256, 512), (13, 512, 512), "M"]
_FC_PLAN = [(0, 512 * 4 * 6, 4096), (2, 4096, 4096), (4, 4096, 128)]


def _hertz_to_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def vggish_mel_matrix(cfg: VGGishConfig = VGGishConfig()) -> np.ndarray:
    """(n_fft//2+1, n_mels) HTK mel weights, the upstream
    ``spectrogram_to_mel_matrix`` (triangles in mel space at the bins'
    frequencies, the DC row zeroed)."""
    nbins = cfg.n_fft // 2 + 1
    bins_mel = _hertz_to_mel(np.linspace(0.0, cfg.sample_rate / 2.0, nbins))
    edges = np.linspace(_hertz_to_mel(cfg.mel_min_hz),
                        _hertz_to_mel(cfg.mel_max_hz), cfg.n_mels + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    lo_slope = (bins_mel[:, None] - lower[None, :]) / (center - lower)[None, :]
    hi_slope = (upper[None, :] - bins_mel[:, None]) / (upper - center)[None, :]
    W = np.maximum(0.0, np.minimum(lo_slope, hi_slope))
    W[0, :] = 0.0
    return W.astype(np.float32)


def vggish_log_mel_examples(x: torch.Tensor, cfg: VGGishConfig,
                            mel_w: torch.Tensor) -> torch.Tensor:
    """x (B, T) at cfg.sample_rate -> (B, E, 96, 64) log-mel examples;
    tails that fill no frame or no example are dropped."""
    B = x.shape[0]
    frames = x.unfold(-1, cfg.stft_win, cfg.stft_hop)  # (B, F, win)
    n = torch.arange(cfg.stft_win, dtype=torch.float32, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / cfg.stft_win)
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft, dim=-1).abs()
    log_mel = torch.log(spec @ mel_w + cfg.log_offset)
    E = frames.shape[1] // cfg.example_frames
    return log_mel[:, : E * cfg.example_frames].reshape(
        B, E, cfg.example_frames, cfg.n_mels)


class VGGish(nn.Module):
    """forward(examples (N, 96, 64)) -> (N, 128), the upstream VGG graph
    with its transpose before the flatten; ``postprocess`` adds the PCA
    buffers."""

    def __init__(self, config: VGGishConfig = VGGishConfig(),
                 postprocess: bool = False):
        super().__init__()
        self.config = config
        layers, in_c = [], 1
        for item in _VGG_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                _, in_c, out_c = item
                layers += [nn.Conv2d(in_c, out_c, 3, padding=1), nn.ReLU()]
        self.features = nn.Sequential(*layers)
        fc = []
        for _, fan_in, fan_out in _FC_PLAN:
            fc += [nn.Linear(fan_in, fan_out), nn.ReLU()]
        self.embeddings = nn.Sequential(*fc)
        if postprocess:
            self.register_buffer("pca_eigen_vectors",
                                 torch.zeros(config.embed_dim,
                                             config.embed_dim))
            self.register_buffer("pca_means", torch.zeros(config.embed_dim))
        frozen(self)

    @property
    def postprocess(self) -> bool:
        return hasattr(self, "pca_eigen_vectors")

    def forward(self, examples: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            x = self.features(examples[:, None].to(torch.float32))
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (N, H, W, C)
            return self.embeddings(x)


def vggish_postprocess(pca: dict, e: torch.Tensor) -> torch.Tensor:
    """The upstream PCA postprocessor on e (N, 128): project, clip to
    [-2, 2], quantise to 0..255 (kept as float). ``pca`` holds
    ``pca_eigen_vectors`` (128, 128) and ``pca_means``."""
    M = pca["pca_eigen_vectors"]
    mu = pca["pca_means"].reshape(-1)
    with no_tf32():
        v = (e - mu[None, :]) @ M.T
    return torch.round((torch.clamp(v, -2.0, 2.0) + 2.0) * (255.0 / 4.0))


@dataclasses.dataclass
class VGGishModel:
    net: VGGish
    config: VGGishConfig = VGGishConfig()
    embed_dim: int = 128


def load_vggish_model(ckpt_path: str | None = None,
                      pca_path: str | None = None,
                      allow_random: bool = False, seed: int = 0,
                      device="cuda") -> VGGishModel:
    """VGGish on ``device`` (default the card): the upstream ``vggish.pth``
    at ``ckpt_path`` (and its PCA parameters at ``pca_path`` where that
    file exists), or with ``allow_random`` and no file random weights from
    a ``torch.Generator`` seeded with ``seed`` (no PCA)."""
    if ckpt_path and os.path.isfile(ckpt_path):
        dev = resolve_device(device)
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        sd = {k: v for k, v in sd.items()
              if k.startswith(("features.", "embeddings."))}
        pca = None
        if pca_path and os.path.isfile(pca_path):
            pca = torch.load(pca_path, map_location="cpu", weights_only=False)
            sd["pca_eigen_vectors"] = torch.as_tensor(
                np.asarray(pca["pca_eigen_vectors"]), dtype=torch.float32)
            sd["pca_means"] = torch.as_tensor(
                np.asarray(pca["pca_means"]), dtype=torch.float32).reshape(-1)
        net = VGGish(postprocess=pca is not None)
        net.load_state_dict(sd)
        return VGGishModel(net=frozen(net.to(dev)))
    if allow_random:
        dev = resolve_device(device)
        net = xavier_init_(VGGish(), torch.Generator().manual_seed(seed))
        return VGGishModel(net=frozen(net.to(dev)))
    raise FileNotFoundError(
        "VGGish weights unavailable (torch.hub needs network access); pass "
        "a local ckpt_path or allow_random=True")


def get_vggish_embeds(x: torch.Tensor, model: VGGishModel, sample_rate,
                      **kwargs) -> dict[str, torch.Tensor]:
    """{"mono": (B, 128)}: x (B, C, T) mixed to mono, resampled to 16 kHz,
    cut into 0.96 s examples, each embedded (and PCA-postprocessed where
    the model has the PCA), the mean over each item's examples. Not
    normalised."""
    from st_ito_torch.ops.resample import resample

    cfg = model.config
    B = x.shape[0]
    mono = resample(x.to(torch.float32).mean(dim=1), int(sample_rate),
                    cfg.sample_rate)
    mel_w = torch.as_tensor(vggish_mel_matrix(cfg), device=x.device)
    with no_tf32():
        ex = vggish_log_mel_examples(mono, cfg, mel_w)
    E = ex.shape[1]
    emb = model.net(ex.reshape(B * E, cfg.example_frames, cfg.n_mels))
    if model.net.postprocess:
        emb = vggish_postprocess(dict(model.net.named_buffers()), emb)
    return {"mono": emb.reshape(B, E, -1).mean(dim=1)}
