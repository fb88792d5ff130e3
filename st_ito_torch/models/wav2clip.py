"""The Wav2CLIP audio tower as an ``nn.Module`` — port of
``st_ito_tpu/models/wav2clip.py`` (upstream descriptinc/lyrebird-wav2clip,
Wu et al. 2022): a log-mel spectrogram -> ResNet-18 (torchvision's
BasicBlock layout with a 1-channel stem) -> global average pool -> fc ->
512-d -> the release's projection MLP (``transform``).

The module's parameter names are the release's ``state_dict``'s: the
ResNet under ``encoder.`` and the MLP under ``transform.sequential.``.
The spectrogram front end's constants (``Wav2ClipConfig``) are the JAX
package's. It runs in float32 with cuDNN's TF32 off. Embeddings are not
normalised, as in the reference wrapper.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.models.encoders import frozen
from st_ito_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class Wav2ClipConfig:
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 64
    mel_min_hz: float = 0.0
    mel_max_hz: float = 8000.0
    log_eps: float = 1e-10
    embed_dim: int = 512
    stem_channels: int = 64


_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]  # (channels, first stride)


class BasicBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, out_c, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_c)
        self.conv2 = nn.Conv2d(out_c, out_c, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_c)
        self.downsample = None
        if stride != 1 or in_c != out_c:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_c, out_c, 1, stride, bias=False),
                nn.BatchNorm2d(out_c))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class ResNet18(nn.Module):
    """spec (N, 1, n_mels, frames) -> (N, embed_dim): stem 7x7/2 and a
    3x3/2 max pool, 4 stages of 2 BasicBlocks, global average pool, fc."""

    def __init__(self, embed_dim: int = 512):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_c = 64
        for si, (out_c, stride) in enumerate(_STAGES, start=1):
            setattr(self, f"layer{si}", nn.Sequential(
                BasicBlock(in_c, out_c, stride), BasicBlock(out_c, out_c, 1)))
            in_c = out_c
        self.fc = nn.Linear(512, embed_dim)

    def forward(self, spec):
        x = F.relu(self.bn1(self.conv1(spec)))
        x = F.max_pool2d(x, 3, 2, 1)
        for si in range(1, len(_STAGES) + 1):
            x = getattr(self, f"layer{si}")(x)
        return self.fc(x.mean(dim=(2, 3)))


class Transform(nn.Module):
    """The release's projection MLP: Linear -> ReLU -> Linear."""

    def __init__(self, embed_dim: int = 512):
        super().__init__()
        self.sequential = nn.Sequential(nn.Linear(embed_dim, 512), nn.ReLU(),
                                        nn.Linear(512, 512))

    def forward(self, e):
        return self.sequential(e)


class Wav2Clip(nn.Module):
    """forward(spec) -> the tower's embedding, through ``transform`` when
    the model has it."""

    def __init__(self, config: Wav2ClipConfig = Wav2ClipConfig(),
                 transform: bool = True):
        super().__init__()
        self.config = config
        self.encoder = ResNet18(config.embed_dim)
        self.transform = Transform(config.embed_dim) if transform else None
        frozen(self)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            e = self.encoder(spec.to(torch.float32))
            return e if self.transform is None else self.transform(e)


def wav2clip_mel_matrix(cfg: Wav2ClipConfig = Wav2ClipConfig()) -> np.ndarray:
    """Slaney-normalised mel filterbank, (n_fft//2+1, n_mels)."""
    from st_ito_torch.ops.stft import mel_filterbank

    return mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                          cfg.mel_min_hz, cfg.mel_max_hz).numpy()


def wav2clip_log_mel(x: torch.Tensor, cfg: Wav2ClipConfig,
                     mel_w: torch.Tensor) -> torch.Tensor:
    """x (B, T) -> (B, 1, n_mels, frames): a centred STFT with a periodic
    Hann of win_length centred in the n_fft frame (torch.stft's layout),
    the power spectrum, the mel bands, the natural log."""
    from st_ito_torch.ops.stft import hann_window, stft

    w = hann_window(cfg.win_length, device=x.device)
    lpad = (cfg.n_fft - cfg.win_length) // 2
    w = F.pad(w, (lpad, cfg.n_fft - cfg.win_length - lpad))
    power = stft(x, cfg.n_fft, cfg.hop_length, center=True, window=w).abs() ** 2
    mel = torch.einsum("btf,fm->bmt", power, mel_w)
    return torch.log(torch.clamp_min(mel, cfg.log_eps))[:, None]


@dataclasses.dataclass
class Wav2ClipModel:
    net: Wav2Clip
    config: Wav2ClipConfig = Wav2ClipConfig()
    embed_dim: int = 512


def release_state_dict(sd: dict) -> dict:
    """A Wav2CLIP ``state_dict`` in the release's names: bare torchvision
    ResNet keys gain ``encoder.``, a plain MLP's ``transform.{i}`` becomes
    ``transform.sequential.{i}``."""
    out = {}
    for k, v in sd.items():
        if k.startswith("transform.") and not k.startswith(
                "transform.sequential."):
            k = "transform.sequential." + k[len("transform."):]
        elif not k.startswith(("encoder.", "transform.")):
            k = "encoder." + k
        out[k] = v
    return out


def init_wav2clip_(net: Wav2Clip, generator: torch.Generator) -> Wav2Clip:
    """The JAX init_wav2clip_params scheme: He-normal convs, default BN,
    Xavier-uniform fc and projection weights, zero biases."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / fan))
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                a = math.sqrt(6.0 / (512 + net.config.embed_dim))
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator)
                                * 2.0 - 1.0) * a)
                m.bias.zero_()
    return net


def load_wav2clip_model(ckpt_path: str | None = None,
                        allow_random: bool = False, seed: int = 0,
                        device="cuda") -> Wav2ClipModel:
    """Wav2CLIP on ``device`` (default the card): the release's
    ``Wav2CLIP.pt`` at ``ckpt_path`` (a ``state_dict`` entry if it has
    one), or with ``allow_random`` and no file random weights from a
    ``torch.Generator`` seeded with ``seed``."""
    if ckpt_path and os.path.isfile(ckpt_path):
        dev = resolve_device(device)
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = release_state_dict(sd)
        net = Wav2Clip(transform=any(k.startswith("transform.") for k in sd))
        net.load_state_dict(sd)
        return Wav2ClipModel(net=frozen(net.to(dev)))
    if allow_random:
        dev = resolve_device(device)
        net = init_wav2clip_(Wav2Clip(), torch.Generator().manual_seed(seed))
        return Wav2ClipModel(net=frozen(net.to(dev)))
    raise FileNotFoundError(
        "Wav2CLIP checkpoint unavailable offline; pass a local Wav2CLIP.pt "
        "or allow_random=True")


def get_wav2clip_embeds(x: torch.Tensor, model: Wav2ClipModel, sample_rate,
                        **kwargs) -> dict[str, torch.Tensor]:
    """{"mono": (B, 512)}: x (B, C, T) mixed to mono, resampled to 16 kHz,
    its log-mel through the tower. Not normalised."""
    from st_ito_torch.ops.resample import resample

    cfg = model.config
    mono = resample(x.to(torch.float32).mean(dim=1), int(sample_rate),
                    cfg.sample_rate)
    mel_w = torch.as_tensor(wav2clip_mel_matrix(cfg), device=x.device)
    with no_tf32():
        spec = wav2clip_log_mel(mono, cfg, mel_w)
    return {"mono": model.net(spec)}
