"""AFx-Rep backbone: the mid/side Cnn14 as an ``nn.Module`` — port of
``st_ito_tpu/models/cnn14.py``, in eval mode and in train mode.

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

Train mode (``net.train()``, on a module the trainer builds and unfreezes
for itself): BatchNorm by batch statistics through the modules' own
buffers (momentum 0.1, the unbiased variance into the running variance:
the convention of the JAX package's ``_batchnorm``), the conv stack in
float32 outputs, and with a ``generator`` passed to ``forward``
SpecAugment (2 time stripes of at most 64 frames, 2 frequency stripes of
at most 8 bins) and dropout at keep 0.8 after every block, drawn in the
JAX package's order by ``spec_augment_draws`` and ``dropout_keep``.
``bn_stats_frozen`` keeps one forward from updating the buffers, as the
JAX trainers keep the update of one forward a step only.
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
from st_ito_torch.parallel.batchnorm import global_batch_norm
from st_ito_torch.parallel.collectives import active, global_draw

_BN_EPS = 1e-5
KEEP = 0.8  # dropout's keep rate after every block in train mode
TIME_STRIPES = ((64, 2),)  # SpecAugment: (most frames, stripes)
FREQ_STRIPES = ((8, 2),)  # (most mel bins, stripes)


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


@contextlib.contextmanager
def bn_stats_frozen(module: nn.Module):
    """Train-mode BatchNorm inside normalises by batch statistics and leaves
    the running buffers as they are (``track_running_stats`` off for the
    call); restores the flags."""
    bns = [m for m in module.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    saved = [m.track_running_stats for m in bns]
    for m in bns:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m, t in zip(bns, saved):
            m.track_running_stats = t


def spec_augment_draws(generator: torch.Generator, n: int, frames: int,
                       bins: int, device) -> list:
    """SpecAugment's stripes as [(starts, widths), ...], each (n,) int64:
    the time stripes, then the frequency stripes, each stripe's starts
    before its widths (the JAX ``_spec_augment`` order). Inside a mesh's
    ``sharded`` scope, this rank's rows of the global batch's draws."""
    def randint(high):
        return global_draw(lambda shape: torch.randint(
            0, high, shape, generator=generator, device=device), (n,))

    out = []
    for size, specs in ((frames, TIME_STRIPES), (bins, FREQ_STRIPES)):
        for width, stripes in specs:
            for _ in range(stripes):
                starts = randint(max(size - width, 1))
                widths = randint(width + 1)
                out.append((starts, widths))
    return out


def dropout_keep(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Dropout's keep mask (True with probability KEEP); this rank's rows
    of the global batch's inside a mesh's ``sharded`` scope."""
    return global_draw(lambda s: torch.rand(s, generator=generator,
                                            device=device), shape) < KEEP


def spec_augment(h: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """h (N, 1, frames, bins) with each stripe [start, start + width) set
    to 0."""
    N, _, frames, bins = h.shape
    stripes = spec_augment_draws(generator, N, frames, bins, h.device)
    n_time = sum(s for _, s in TIME_STRIPES)
    t_idx = torch.arange(frames, device=h.device)
    f_idx = torch.arange(bins, device=h.device)
    mask = torch.ones_like(h)
    for i, (starts, widths) in enumerate(stripes):
        idx = t_idx if i < n_time else f_idx
        m = ~((idx[None] >= starts[:, None])
              & (idx[None] < (starts + widths)[:, None]))
        m = m[:, None, :, None] if i < n_time else m[:, None, None, :]
        mask = mask * m.to(h.dtype)
    return h * mask


def time_pool(h: torch.Tensor) -> torch.Tensor:
    """(N, C, frames) -> (N, C): the max over time plus the mean. (The
    gradient follows the max's frame, so it jumps where two frames nearly
    tie and rounding picks the other.)"""
    return h.amax(dim=2) + h.mean(dim=2)


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

    def forward(self, x, pool: bool, dtype: torch.dtype,
                generator: torch.Generator | None = None):
        if self.training:
            return self._forward_train(x, pool, dtype, generator)
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

    def _forward_train(self, x, pool, dtype, generator):
        """Batch-statistics BatchNorm on conv outputs in the weights' dtype
        (float32, or float64 in a witness run), then dropout when a
        generator is given."""
        h = x
        for conv, bn in ((self.conv1, getattr(self, "bn1", None)),
                         (self.conv2, getattr(self, "bn2", None))):
            h = F.conv2d(h.to(dtype), conv.weight.to(dtype),
                         padding=1).to(conv.weight.dtype)
            if bn is not None:
                h = bn(h)
            h = torch.relu(h)
        if pool:
            h = F.avg_pool2d(h, 2)
        if generator is not None:
            keep = dropout_keep(generator, h.shape, h.device)
            h = torch.where(keep, h / KEEP, torch.zeros_like(h))
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

    def forward(self, x: torch.Tensor, compute_dtype: str | None = None,
                generator: torch.Generator | None = None):
        """In train mode a ``generator`` draws SpecAugment's stripes and
        the dropout masks; without one neither runs (the JAX apply without
        an rng). In eval mode it is not read."""
        cfg = self.config
        if not self.training:
            generator = None
        dtype = getattr(torch, compute_dtype or cfg.compute_dtype)
        batch, chs, seq_len = x.shape
        frames = seq_len // cfg.hop_size + 1
        if frames >> 5 == 0:
            raise ValueError(
                f"input length {seq_len} yields {frames} logmel frames; "
                f"Cnn14 needs >= 32 frames (>= {31 * cfg.hop_size} samples "
                f"at hop={cfg.hop_size})")
        x = x.to(self.window.dtype)  # float32, float64 in a witness
        if chs == 2:
            x = torch.stack([(x[:, 0] + x[:, 1]) / 2.0,
                             (x[:, 0] - x[:, 1]) / 2.0], dim=1)
        with no_tf32():
            h = self.logmel(x.reshape(batch * chs, seq_len))
            if cfg.input_norm == "batchnorm" and self.training and active():
                # the global batch's statistics over the active mesh
                h = global_batch_norm(h.transpose(1, 3), None, None,
                                      self.bn0.weight, self.bn0.bias, True,
                                      0.0, _BN_EPS, active()).transpose(1, 3)
            elif cfg.input_norm == "batchnorm":
                # in train mode by batch statistics, its update dropped (as
                # the JAX apply drops it)
                h = F.batch_norm(h.transpose(1, 3), self.bn0.running_mean,
                                 self.bn0.running_var, self.bn0.weight,
                                 self.bn0.bias, self.training, 0.0,
                                 _BN_EPS).transpose(1, 3)
            elif cfg.input_norm == "minmax":
                h = (torch.clamp(h, -80.0, 40.0) + 80.0) / 120.0 * 2.0 - 1.0
            elif cfg.input_norm != "none":
                raise ValueError(f"Invalid input_norm: {cfg.input_norm}")
            if generator is not None:
                h = spec_augment(h, generator)
            for i in range(6):
                h = getattr(self, f"conv_block{i + 1}")(
                    h, pool=i < 5, dtype=dtype, generator=generator)
            h = time_pool(h.to(self.window.dtype).mean(dim=3))
            h = h.reshape(batch, chs, -1)
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
