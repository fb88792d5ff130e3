"""DeepGCN, the ViG-style graph encoder, as an ``nn.Module`` — port of
``st_ito_tpu/models/gcn.py``, a pretext-encoder alternative
(``cfg/pretext-gcn.yaml``, model size ``t``): a log-mel front end (2048 /
512, fmax 4 kHz) standardised per item, an overlapping conv stem (/4), a
learned positional embedding, four stages of [Grapher -> FFN] blocks with a
strided conv between stages, a global average pool and a 1x1-conv head.

The Grapher is a 1x1 conv and BatchNorm, a dynamic k-NN max-relative
graph convolution (the candidates an r x r average pool of the nodes,
r = 4, 2, 1, 1 by stage; the squared distances formed as xx - 2xy + yy and
the k nearest taken by ``topk``, as ``jax.lax.top_k`` of the negated
distances takes them), a 1x1 conv and BatchNorm and the residual.

As in the JAX module: the strided convs pad as XLA's "SAME" does, the
excess (max((ceil(H/s) - 1) s + k - H, 0)) split with the smaller half
low, which is (0, 1) at stride 2 on even sizes where ``nn.Conv2d(padding=
1)`` would pad (1, 1); GELU is the tanh approximation (``jax.nn.gelu``'s
default). The BatchNorms are ``nn.BatchNorm2d``: in train mode they
normalise by the batch's statistics and update their running statistics
in place, torch's convention (momentum 0.1, the unbiased variance), which
the JAX package records through ``models/bn_stats.py``; in eval mode they
use the running ones. In train mode and given a ``torch.Generator``, the
head drops elements before its last conv (keep 0.8, the kept scaled by
1 / 0.8). The parameter names are the JAX pytree's (``stem.{i}``,
``pos_embed``, ``backbone.{i}.{down | fc1,mr_nn,fc2,ffn1,ffn2}``,
``pred1``, ``pred2``; each conv's ``weight``, ``bias`` and ``bn``). It
runs in float32 with TF32 off (``no_tf32``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.models.htsat import standardized_logmel
from st_ito_torch.ops.stft import mel_filterbank
from st_ito_torch.parallel.collectives import global_draw

_SIZES = {
    "t": ([2, 2, 6, 2], [48, 96, 240, 384]),
    "s": ([2, 2, 6, 2], [80, 160, 400, 640]),
    "m": ([2, 2, 16, 2], [96, 192, 384, 768]),
    "b": ([2, 2, 18, 2], [128, 256, 512, 1024]),
}
REDUCE_RATIOS = (4, 2, 1, 1)
# the head's dropout: the probability of keeping an element
KEEP = 0.8


@dataclasses.dataclass(frozen=True)
class DeepGCNConfig:
    embed_dim: int = 512
    model_size: str = "t"
    k: int = 9
    sample_rate: float = 48000.0
    window_size: int = 2048
    hop_size: int = 512
    mel_bins: int = 128
    fmin: float = 20.0
    fmax: float = 4000.0
    num_frames: int = 512  # spectrogram frames consumed (crop/pad)

    @property
    def blocks(self):
        return _SIZES[self.model_size][0]

    @property
    def channels(self):
        return _SIZES[self.model_size][1]


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x (B, C, H, W) padded with zeros as XLA's "SAME" pads a k x k
    window at ``stride``: in each dimension the excess max((ceil(n / s) -
    1) s + k - n, 0), its smaller half low."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ConvBN(nn.Module):
    """A conv with bias under "SAME" padding, then a BatchNorm2d."""

    def __init__(self, out_c: int, in_c: int, k: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(out_c, in_c, k, k))
        self.bias = nn.Parameter(torch.zeros(out_c))
        self.bn = nn.BatchNorm2d(out_c)

    def forward(self, x):
        x = same_pad(x, self.weight.shape[-1], self.stride)
        return self.bn(F.conv2d(x, self.weight, self.bias,
                                stride=self.stride))


class Conv1x1(nn.Module):
    def __init__(self, out_c: int, in_c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_c, in_c, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_c))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias)


class Downsample(nn.Module):
    def __init__(self, out_c: int, in_c: int):
        super().__init__()
        self.down = ConvBN(out_c, in_c, 3, stride=2)

    def forward(self, x):
        return self.down(x)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def knn_indices(feat: torch.Tensor, cand: torch.Tensor, k: int
                ) -> torch.Tensor:
    """(B, N, k) indices of each node's k nearest candidates (feat (B, C,
    N), cand (B, C, M)) by squared distance, formed as xx - 2xy + yy."""
    xx = torch.sum(feat ** 2, dim=1)[:, :, None]
    yy = torch.sum(cand ** 2, dim=1)[:, None, :]
    xy = feat.transpose(1, 2) @ cand  # (B, N, M)
    dist = xx - 2 * xy + yy
    return torch.topk(-dist, min(k, cand.shape[-1]), dim=-1).indices


def mr_graph_conv(x: torch.Tensor, mr_nn: ConvBN, k: int, r: int
                  ) -> torch.Tensor:
    """The max-relative dynamic k-NN graph conv on x (B, C, H, W): each
    node's k nearest candidates (``knn_indices``), the most of (neighbour
    - node) per channel beside the node's own features, then ``mr_nn`` and
    GELU."""
    B, C, H, W = x.shape
    feat = x.reshape(B, C, H * W)
    cand = F.avg_pool2d(x, r, r).reshape(B, C, -1) if r > 1 else feat
    M = cand.shape[-1]
    idx = knn_indices(feat, cand, k)
    N = feat.shape[-1]
    nbrs = torch.gather(cand[:, :, None, :].expand(B, C, N, M), 3,
                        idx[:, None].expand(B, C, N, idx.shape[-1]))
    agg = torch.amax(nbrs - feat[..., None], dim=-1)  # (B, C, N)
    h = torch.cat([feat, agg], dim=1).reshape(B, 2 * C, H, W)
    return _gelu(mr_nn(h))


class GrapherFFN(nn.Module):
    """One backbone block: the Grapher (fc1, the graph conv's mr_nn, fc2,
    residual), then the FFN (ffn1, GELU, ffn2, residual)."""

    def __init__(self, c: int):
        super().__init__()
        self.fc1 = ConvBN(c, c, 1)
        self.mr_nn = ConvBN(2 * c, 2 * c, 1)
        self.fc2 = ConvBN(c, 2 * c, 1)
        self.ffn1 = ConvBN(4 * c, c, 1)
        self.ffn2 = ConvBN(c, 4 * c, 1)

    def forward(self, h, k: int, r: int):
        g = mr_graph_conv(self.fc1(h), self.mr_nn, k, r)
        h = self.fc2(g) + h
        return self.ffn2(_gelu(self.ffn1(h))) + h


def head_dropout(h: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """Each element kept with probability KEEP (its mask drawn from
    ``generator``, on h's device) and scaled by 1 / KEEP, the rest 0."""
    keep = global_draw(lambda s: torch.rand(s, generator=generator,
                                            device=h.device), h.shape) < KEEP
    return torch.where(keep, h / KEEP, 0.0)


class DeepGCN(nn.Module):
    """forward(x (B, C, T), generator=None) -> (embed, embed), (B,
    embed_dim) each, from the mono mix. The module's mode is the JAX
    apply's ``training``."""

    def __init__(self, config: DeepGCNConfig = DeepGCNConfig()):
        super().__init__()
        cfg = self.config = config
        blocks, channels = cfg.blocks, cfg.channels
        c0 = channels[0]
        self.stem = nn.ModuleList([ConvBN(c0 // 2, 1, 3, 2),
                                   ConvBN(c0, c0 // 2, 3, 2),
                                   ConvBN(c0, c0, 3)])
        self.pos_embed = nn.Parameter(torch.zeros(
            1, c0, cfg.mel_bins // 4, cfg.num_frames // 4))
        backbone = []
        for i, n in enumerate(blocks):
            if i > 0:
                backbone.append(Downsample(channels[i], channels[i - 1]))
            backbone += [GrapherFFN(channels[i]) for _ in range(n)]
        self.backbone = nn.ModuleList(backbone)
        self.pred1 = Conv1x1(1024, channels[-1])
        self.pred2 = Conv1x1(cfg.embed_dim, 1024)
        # the front end's filterbank, built once (not in the state_dict)
        self.register_buffer("mel_fb", mel_filterbank(
            cfg.sample_rate, cfg.window_size, cfg.mel_bins, cfg.fmin,
            cfg.fmax), persistent=False)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        cfg = self.config
        mel_db = standardized_logmel(x, cfg.window_size, cfg.hop_size,
                                     cfg.num_frames, self.mel_fb)
        with no_tf32():
            h = mel_db.transpose(1, 2)[:, None]  # (B, 1, mel, frames)
            for i, conv in enumerate(self.stem):
                h = conv(h)
                if i < 2:
                    h = _gelu(h)
            h = h + self.pos_embed
            stage = 0
            for entry in self.backbone:
                if isinstance(entry, Downsample):
                    h = entry(h)
                    stage += 1
                else:
                    h = entry(h, cfg.k, REDUCE_RATIOS[stage])
            h = _gelu(self.pred1(h.mean(dim=(2, 3), keepdim=True)))
            if self.training and generator is not None:
                h = head_dropout(h, generator)
            e = self.pred2(h)[:, :, 0, 0]
        return e, e


def init_deepgcn_(net: DeepGCN, generator: torch.Generator) -> DeepGCN:
    """The JAX init scheme: He-normal conv weights (std sqrt(2 / fan_in)),
    zero biases and positional embedding, default BatchNorms."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (ConvBN, Conv1x1)):
                w = m.weight
                std = math.sqrt(2.0 / w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
                m.reset_running_stats()
        net.pos_embed.zero_()
    return net
