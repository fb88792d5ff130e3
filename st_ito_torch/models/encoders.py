"""The dsTCN and FX-encoder as ``nn.Module``s — port of
``st_ito_tpu/models/encoders.py`` in eval mode.

- dsTCN: a raw-waveform downsampling TCN, N residual blocks of a strided
  dilated conv1d and PReLU, max + mean pooling over time, a linear head. A
  pretext-encoder alternative; its parameter names are the JAX pytree's
  (``blocks.{n}.conv1``, ``blocks.{n}.prelu``, ``blocks.{n}.res_conv``,
  ``fc``).
- FX-encoder (Koo et al., mixing-style transfer): 12 residual 1-D conv
  blocks on the stereo waveform (kernels 25 -> 5, strides 4 -> 1,
  reflection padding to "same", BatchNorm, ReLU), global average pooling
  -> a 2048-d embedding. An eval-only metric baseline. Its parameter names
  are the release's ``state_dict``'s (``encoder.{i}.conv{1,2}.conv1d.
  {conv1d,batch_norm}.*``), so a release checkpoint loads as it is once
  its DDP ``module.`` prefix is stripped.

Both run in float32 with cuDNN's TF32 off (``cnn14.no_tf32``): their
embeddings are metrics. Random weights come from a ``torch.Generator``
(the JAX init schemes; the numbers differ, as the two frameworks' random
streams do).
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict

import torch
import torch.nn as nn

from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.utils import resolve_device


def _uniform_(t: torch.Tensor, a: float, generator: torch.Generator):
    t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * a)


def xavier_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-uniform conv and linear weights, zero biases, default norm
    statistics: the JAX init schemes of the dsTCN (whose PReLU slopes stay
    at their 0.25), the FX-encoder and VGGish."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                receptive = m.weight[0, 0].numel()
                fan_in = m.weight.shape[1] * receptive
                fan_out = m.weight.shape[0] * receptive
                _uniform_(m.weight, math.sqrt(6.0 / (fan_in + fan_out)),
                          generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d,
                                nn.LayerNorm)):
                m.reset_parameters()
    return net


def frozen(net: nn.Module) -> nn.Module:
    """Eval mode, no parameter requiring grad."""
    net.eval()
    net.requires_grad_(False)
    return net


# --------------------------------------------------------------------------
# dsTCN
# --------------------------------------------------------------------------

DSTCN_KEEP = 0.5  # the pooled features' dropout in train mode


@dataclasses.dataclass(frozen=True)
class DsTCNConfig:
    embed_dim: int = 512
    ninputs: int = 1
    nblocks: int = 8
    kernel_size: int = 13
    stride: int = 4
    dilation_growth: int = 8
    channel_growth: int = 2
    channel_width: int = 32
    stack_size: int = 4

    def block_channels(self):
        chans = []
        out_c = self.channel_width
        in_c = self.ninputs
        for n in range(self.nblocks):
            if n > 0:
                in_c = out_c
                out_c = in_c * self.channel_growth
            chans.append((in_c, out_c))
        return chans


class DsTCNBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, cfg: DsTCNConfig, n: int):
        super().__init__()
        self.dilation = cfg.dilation_growth ** (n % cfg.stack_size)
        self.stride = cfg.stride
        self.pad = ((cfg.kernel_size - 1) * self.dilation) // 2
        self.conv1 = nn.Conv1d(in_c, out_c, cfg.kernel_size)
        self.prelu = nn.Parameter(torch.full((out_c,), 0.25))
        self.res_conv = nn.Conv1d(in_c, out_c, 1)

    def forward(self, x):
        h = nn.functional.conv1d(x, self.conv1.weight, self.conv1.bias,
                                 stride=self.stride, padding=self.pad,
                                 dilation=self.dilation)
        h = torch.where(h >= 0, h, self.prelu[None, :, None] * h)
        res = nn.functional.conv1d(x, self.res_conv.weight,
                                   self.res_conv.bias, stride=self.stride)
        # conv1 and res_conv can differ by a sample at odd paddings; crop
        L = min(h.shape[-1], res.shape[-1])
        return h[..., :L] + res[..., :L]


class DsTCN(nn.Module):
    """forward(x (B, C, T)) -> (embed, embed): a single-head encoder whose
    mid and side are one embedding. Input of another channel count than
    ``ninputs`` is mixed to mono (and duplicated for ``ninputs`` 2)."""

    def __init__(self, config: DsTCNConfig = DsTCNConfig()):
        super().__init__()
        self.config = config
        self.blocks = nn.ModuleList(
            DsTCNBlock(in_c, out_c, config, n)
            for n, (in_c, out_c) in enumerate(config.block_channels()))
        self.fc = nn.Linear(config.block_channels()[-1][1], config.embed_dim)
        frozen(self)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """In train mode with a ``generator``: dropout at keep 0.5 on the
        pooled features before ``fc`` (the JAX apply with an rng)."""
        cfg = self.config
        x = x.to(torch.float32)
        if x.shape[1] != cfg.ninputs:
            x = x.mean(dim=1, keepdim=True)
            if cfg.ninputs == 2:
                x = torch.cat([x, x], dim=1)
        with no_tf32():
            for block in self.blocks:
                x = block(x)
            e = x.amax(dim=2) + x.mean(dim=2)
            if self.training and generator is not None:
                keep = torch.rand(e.shape, generator=generator,
                                  device=e.device) < DSTCN_KEEP
                e = torch.where(keep, e / DSTCN_KEEP, torch.zeros_like(e))
            e = self.fc(e)
        return e, e


# --------------------------------------------------------------------------
# FX-encoder
# --------------------------------------------------------------------------

_FXE_CHANNELS = (2, 16, 32, 64, 128, 256, 256, 512, 512, 1024, 1024, 2048,
                 2048)
_FXE_KERNELS = (25, 25, 15, 15, 10, 10, 10, 10, 5, 5, 5, 5)
_FXE_STRIDES = (4, 4, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1)


@dataclasses.dataclass(frozen=True)
class FXEncoderConfig:
    embed_dim: int = 2048
    channels: tuple = _FXE_CHANNELS
    kernels: tuple = _FXE_KERNELS
    strides: tuple = _FXE_STRIDES


class ConvLayer(nn.Module):
    """The release's Conv1d_layer: reflection pad to "same", conv,
    BatchNorm, ReLU, nested as ``conv1d.{conv1d_pad,conv1d,batch_norm,
    relu}``."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int):
        super().__init__()
        pad = k - 1
        self.conv1d = nn.Sequential(OrderedDict([
            ("conv1d_pad", nn.ReflectionPad1d((pad // 2, pad - pad // 2))),
            ("conv1d", nn.Conv1d(in_c, out_c, k, stride=stride)),
            ("batch_norm", nn.BatchNorm1d(out_c)),
            ("relu", nn.ReLU()),
        ]))

    def forward(self, x):
        return self.conv1d(x)


class ResConvBlock(nn.Module):
    """conv1 (in -> in, stride 1) plus the residual, then conv2 (in -> out,
    stride s)."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int):
        super().__init__()
        self.conv1 = ConvLayer(in_c, in_c, k, 1)
        self.conv2 = ConvLayer(in_c, out_c, k, stride)

    def forward(self, x):
        return self.conv2(self.conv1(x) + x)


class FXEncoder(nn.Module):
    """forward(x (B, 2, T)) -> (B, channels[-1]), globally average-pooled."""

    def __init__(self, config: FXEncoderConfig = FXEncoderConfig()):
        super().__init__()
        self.config = config
        self.encoder = nn.Sequential(*(
            ResConvBlock(config.channels[i], config.channels[i + 1], k,
                         config.strides[i])
            for i, k in enumerate(config.kernels)))
        frozen(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self.encoder(x.to(torch.float32)).mean(dim=-1)


@dataclasses.dataclass
class FXEncoderModel:
    net: FXEncoder
    config: FXEncoderConfig = FXEncoderConfig()
    embed_dim: int = 2048


def load_fx_encoder_model(ckpt_path: str | None = None,
                          allow_random: bool = False, seed: int = 0,
                          config: FXEncoderConfig = FXEncoderConfig(),
                          device="cuda") -> FXEncoderModel:
    """The FX-encoder at ``config`` (default the release's) on ``device``
    (default the card): the release's checkpoint at ``ckpt_path`` (its
    ``model`` entry, the DDP ``module.`` prefix stripped), or with
    ``allow_random`` and no file random weights from a ``torch.Generator``
    seeded with ``seed``."""
    if ckpt_path and os.path.isfile(ckpt_path):
        from st_ito_torch.models.convert import strip_prefix

        dev = resolve_device(device)
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt)
        if any(k.startswith("module.") for k in sd):
            sd = strip_prefix(sd, "module.")
        net = FXEncoder(config)
        missing, _ = net.load_state_dict(sd, strict=False)
        if missing:
            raise KeyError(f"{ckpt_path}: FX-encoder weights missing {missing}")
        return FXEncoderModel(net=frozen(net.to(dev)), config=config,
                              embed_dim=config.embed_dim)
    if allow_random:
        dev = resolve_device(device)
        net = xavier_init_(FXEncoder(config),
                           torch.Generator().manual_seed(seed))
        return FXEncoderModel(net=frozen(net.to(dev)), config=config,
                              embed_dim=config.embed_dim)
    raise FileNotFoundError(
        "FXencoder checkpoint not found; pass ckpt_path or allow_random=True")


def get_fx_encoder_embeds(x: torch.Tensor, model: FXEncoderModel,
                          sample_rate, **kwargs) -> dict[str, torch.Tensor]:
    """{"stereo": (B, 2048)}: x (B, C, T) resampled to 44.1 kHz, divided by
    the batch's peak, mono made stereo, embedded and L2-normalised."""
    from st_ito_torch.models.registry import _l2_normalize
    from st_ito_torch.ops.resample import resample

    y = x.to(torch.float32)
    if int(sample_rate) != 44100:
        y = resample(y, int(sample_rate), 44100)
    y = y / torch.clamp_min(y.abs().max(), 1e-8)
    if y.shape[1] == 1:
        y = torch.cat([y, y], dim=1)
    return {"stereo": _l2_normalize(model.net(y))}
