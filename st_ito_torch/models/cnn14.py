"""AFx-Rep backbone: the mid/side Cnn14 as an ``nn.Module`` — port of
``st_ito_tpu/models/cnn14.py`` in eval mode.

Log-mel front end (hann, center/reflect, power 2, Slaney mel, ref=1,
amin=1e-10), minmax input normalisation, six 2-conv blocks with 2x2 average
pooling (block 6 does not pool) and BatchNorm folded into one scale and
shift, mel-mean then time max + mean pooling, separate ``fc_mid`` and
``fc_side`` heads.

The parameter names are the JAX pytree's dotted paths
(``conv_block1.conv1.weight``, ...; conv weights OIHW in both), so
``models/convert.py`` maps one onto the other by name.

Precision: the front end and the heads always run in float32 (``torch.fft``
for the power spectrum, as the JAX float32 path does; its bfloat16 mode
uses a DFT matrix product instead). ``compute_dtype="bfloat16"`` runs the
conv stack with bfloat16 activations (cuDNN accumulates in float32), as the
JAX fast path does on its accelerator. The float32 conv stack runs with
cuDNN's and cuBLAS's TF32 off, so "float32" means float32 on the card too;
a caller that differentiates through the module keeps TF32 off around its
backward pass as well (``no_tf32``), where cuDNN's convolution gradients
run.

The encoder is frozen (its parameters do not require grad): a forward pass
records an autograd graph only when its input requires grad, as gradient
ITO's does (the JAX package differentiates with respect to the effect
parameters alone), and never on the ES paths, whose inputs do not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from st_ito_torch.ops.stft import (frame_signal, hann_window, mel_filterbank,
                                   power_to_db)

_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Cnn14Config:
    embed_dim: int = 512
    sample_rate: float = 48000.0
    window_size: int = 2048
    hop_size: int = 1024
    mel_bins: int = 128
    fmin: float = 20.0
    fmax: float = 20000.0
    use_batchnorm: bool = True
    input_norm: str = "minmax"
    base_channels: int = 64  # 64 = the deployed Cnn14; smaller for tests
    compute_dtype: str = "float32"  # or "bfloat16" for the conv stack

    @property
    def channels(self) -> tuple[int, ...]:
        b = self.base_channels
        return (b, 2 * b, 4 * b, 8 * b, 16 * b, 32 * b)


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matrix products in full float32 on the card
    (cuDNN's convolutions default to TF32); restores the caller's flags."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


class ConvBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, use_batchnorm: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, out_c, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(out_c, out_c, 3, padding=1, bias=False)
        self.use_batchnorm = use_batchnorm
        if use_batchnorm:
            self.bn1 = nn.BatchNorm2d(out_c)
            self.bn2 = nn.BatchNorm2d(out_c)

    @staticmethod
    def _folded_bn(h, bn: nn.BatchNorm2d):
        """Eval-mode BN as one scale + shift, computed in float32 and
        applied in h's dtype."""
        scale = bn.weight / torch.sqrt(bn.running_var + _BN_EPS)
        shift = bn.bias - bn.running_mean * scale
        return (h * scale.to(h.dtype)[None, :, None, None]
                + shift.to(h.dtype)[None, :, None, None])

    def forward(self, x, pool: bool, dtype: torch.dtype):
        h = F.conv2d(x.to(dtype), self.conv1.weight.to(dtype), padding=1)
        if self.use_batchnorm:
            h = self._folded_bn(h, self.bn1)
        h = torch.relu(h)
        h = F.conv2d(h, self.conv2.weight.to(dtype), padding=1)
        if self.use_batchnorm:
            h = self._folded_bn(h, self.bn2)
        h = torch.relu(h)
        if pool:
            h = F.avg_pool2d(h, 2)
        return h


class Cnn14(nn.Module):
    """forward(x (batch, chs, T), chs in {1, 2}) -> (mid, side), each
    (batch, embed_dim); for mono input side == mid."""

    def __init__(self, config: Cnn14Config):
        super().__init__()
        self.config = config
        self.bn0 = nn.BatchNorm2d(config.mel_bins)
        in_c = 1
        for i, out_c in enumerate(config.channels):
            setattr(self, f"conv_block{i + 1}",
                    ConvBlock(in_c, out_c, config.use_batchnorm))
            in_c = out_c
        self.fc_mid = nn.Linear(config.channels[-1], config.embed_dim)
        self.fc_side = nn.Linear(config.channels[-1], config.embed_dim)
        self.register_buffer(
            "mel_matrix",
            mel_filterbank(config.sample_rate, config.window_size,
                           config.mel_bins, config.fmin, config.fmax),
            persistent=False)
        self.register_buffer("window", hann_window(config.window_size),
                             persistent=False)
        self.eval()
        self.requires_grad_(False)

    def logmel(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T) -> (N, 1, frames, mel_bins) in float32."""
        cfg = self.config
        frames = frame_signal(x, cfg.window_size, cfg.hop_size) * self.window
        S = torch.fft.rfft(frames, dim=-1).abs() ** 2
        mel = S @ self.mel_matrix
        return power_to_db(mel, ref=1.0, amin=1e-10)[:, None]

    def forward(self, x: torch.Tensor, compute_dtype: str | None = None):
        cfg = self.config
        dtype = getattr(torch, compute_dtype or cfg.compute_dtype)
        batch, chs, seq_len = x.shape
        frames = seq_len // cfg.hop_size + 1
        if frames >> 5 == 0:
            raise ValueError(
                f"input length {seq_len} yields {frames} logmel frames; "
                f"Cnn14 needs >= 32 frames (>= {31 * cfg.hop_size} samples "
                f"at hop={cfg.hop_size})")
        x = x.to(torch.float32)
        if chs == 2:
            x = torch.stack([(x[:, 0] + x[:, 1]) / 2.0,
                             (x[:, 0] - x[:, 1]) / 2.0], dim=1)
        with no_tf32():
            h = self.logmel(x.reshape(batch * chs, seq_len))
            if cfg.input_norm == "batchnorm":
                h = F.batch_norm(h.transpose(1, 3), self.bn0.running_mean,
                                 self.bn0.running_var, self.bn0.weight,
                                 self.bn0.bias, False, 0.0,
                                 _BN_EPS).transpose(1, 3)
            elif cfg.input_norm == "minmax":
                h = (torch.clamp(h, -80.0, 40.0) + 80.0) / 120.0 * 2.0 - 1.0
            elif cfg.input_norm != "none":
                raise ValueError(f"Invalid input_norm: {cfg.input_norm}")
            for i in range(6):
                h = getattr(self, f"conv_block{i + 1}")(h, pool=i < 5,
                                                        dtype=dtype)
            h = h.to(torch.float32).mean(dim=3)
            h = (h.amax(dim=2) + h.mean(dim=2)).reshape(batch, chs, -1)
            mid = self.fc_mid(h[:, 0])
            side = mid if chs == 1 else self.fc_side(h[:, 1])
        return mid, side


def init_cnn14_(net: Cnn14, generator: torch.Generator) -> Cnn14:
    """Xavier-uniform conv and linear weights, zero biases and default BN
    statistics (the JAX init_cnn14_params scheme; the numbers differ, as
    the two frameworks' random streams do)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                receptive = m.weight[0, 0].numel()  # kh*kw, or 1
                fan_in = m.weight.shape[1] * receptive
                fan_out = m.weight.shape[0] * receptive
                a = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator)
                                * 2.0 - 1.0) * a)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return net
