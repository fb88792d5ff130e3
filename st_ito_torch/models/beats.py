"""BEATs (iter3+ AS2M) as an ``nn.Module`` — port of
``st_ito_tpu/models/beats.py``, the audio transformer the reference uses as
an eval-only embedding backend.

- a Kaldi fbank front end (25 ms / 10 ms frames, 128 HTK mels, the Povey
  window, pre-emphasis 0.97, snip_edges) written in torch, with the
  published normalisation statistics;
- a 16x16 patch conv to the 512-d embedding, LayerNorm, a projection to
  768;
- the weight-normed grouped positional conv (k 128, 16 groups, the
  trailing element trimmed for an even kernel) and GELU;
- post-LN layers with DeepNorm residual scaling alpha = (2L)^(1/4);
- the T5-style bucketed relative position bias (320 buckets, max distance
  800), from layer 0 and shared by every layer, gated per layer by
  sigmoid(sum of chunks of grep_linear(q)): bias * (a (b grep_a - 1) + 2);
- the alpha = 32 rescaling of the attention logits: q pre-scaled by
  scaling / 32, then (q.k - max) x 32, written out as the reference has it
  (``F.scaled_dot_product_attention`` cannot express it).

The module's parameter names are the released checkpoint's (its
``model`` entry), the positional conv's weight norm kept as its ``weight_g``
and ``weight_v``. It runs in float32 with cuDNN's TF32 off.
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
class BEATsConfig:
    # the released iter3+ AS2M configuration
    embed_dim: int = 512          # patch embedding width
    encoder_embed_dim: int = 768
    depth: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    patch: int = 16
    conv_pos: int = 128
    conv_pos_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    deep_norm: bool = True
    gru_rel_pos: bool = True
    mel_bins: int = 128
    sample_rate: float = 16000.0
    fbank_mean: float = 15.41663
    fbank_std: float = 6.55582


# ------------------------------------------------------------------ fbank


def kaldi_fbank(mono: torch.Tensor, cfg: BEATsConfig) -> torch.Tensor:
    """torchaudio.compliance.kaldi.fbank's defaults at 16 kHz: frames of
    400 every 160 (snip_edges), the DC removed, pre-emphasis 0.97 (the
    first sample against itself), the Povey window (Hann^0.85 over 399),
    n_fft 512, the power spectrum, 128 HTK mels from 20 Hz without norm,
    the natural log floored at Kaldi's epsilon. mono (B, T), already scaled
    by 2^15 -> (B, frames, mel_bins)."""
    from st_ito_torch.ops.stft import mel_filterbank

    frame_len, hop, n_fft = 400, 160, 512
    frames = mono.unfold(-1, frame_len, hop)  # (B, F, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * prev
    k = np.arange(frame_len, dtype=np.float64)
    povey = (0.5 - 0.5 * np.cos(2 * np.pi * k / (frame_len - 1))) ** 0.85
    frames = frames * torch.as_tensor(povey, dtype=torch.float32,
                                      device=mono.device)
    S = torch.fft.rfft(frames, n=n_fft, dim=-1).abs() ** 2
    mel = mel_filterbank(cfg.sample_rate, n_fft, cfg.mel_bins, 20.0,
                         cfg.sample_rate / 2.0, htk=True, norm=None)
    return torch.log(torch.clamp_min(S @ mel.to(mono.device), 1.1921e-07))


def _relative_position_bucket(relative_positions: np.ndarray,
                              num_buckets: int, max_distance: int):
    """T5's bidirectional bucketing of relative positions (numpy ints)."""
    num_buckets = num_buckets // 2
    buckets = (relative_positions > 0).astype(np.int64) * num_buckets
    rel = np.abs(relative_positions)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return buckets + np.where(is_small, rel, large)


# ------------------------------------------------------------- components


class WeightNormConv1d(nn.Module):
    """A grouped conv1d whose weight is g * v / ||v||, the norm over the
    output and input channels at each kernel position (torch's weight_norm
    at dim 2), under the release's names ``weight_g``, ``weight_v``,
    ``bias``."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.zeros(channels, channels // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))

    @property
    def weight(self) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.weight_v, dim=(0, 1),
                                        keepdim=True)
        return self.weight_g * self.weight_v / torch.clamp_min(norm, 1e-12)

    def forward(self, x):
        K = self.weight_v.shape[-1]
        y = F.conv1d(x, self.weight, self.bias, padding=K // 2,
                     groups=self.groups)
        return y[..., :-1] if K % 2 == 0 else y


class MultiheadAttention(nn.Module):
    def __init__(self, cfg: BEATsConfig, has_relative_attention_bias: bool):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.cfg = cfg
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(cfg.num_buckets,
                                                        cfg.heads)
        if cfg.gru_rel_pos:
            self.grep_linear = nn.Linear(d // cfg.heads, 8)
            self.grep_a = nn.Parameter(torch.ones(1, cfg.heads, 1, 1))

    def forward(self, h, pos_bias):
        return _attention(self, h, pos_bias, self.cfg)


def _attention(attn: MultiheadAttention, h: torch.Tensor,
               pos_bias: torch.Tensor | None, cfg: BEATsConfig):
    """The reference MultiheadAttention's forward, batch first.
    pos_bias: (heads, N, N), the shared bias table's values."""
    B, N, D = h.shape
    heads, hd = cfg.heads, D // cfg.heads
    alpha = 32.0
    scaling = hd ** -0.5

    q0 = attn.q_proj(h)  # the raw q, the gate's input
    q = q0 * (scaling / alpha)
    k = attn.k_proj(h)
    v = attn.v_proj(h)

    def split(t):
        return t.reshape(B, N, heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    logits = q @ k.transpose(-1, -2)
    logits = (logits - logits.amax(dim=-1, keepdim=True)) * alpha
    if pos_bias is not None:
        bias = pos_bias[None]
        if cfg.gru_rel_pos:
            gates = attn.grep_linear(split(q0))  # (B, heads, N, 8)
            gates = torch.sigmoid(gates.reshape(B, heads, N, 2, 4).sum(-1))
            gate_a, gate_b = gates[..., 0], gates[..., 1]
            gate_a_1 = gate_a * (gate_b * attn.grep_a[..., 0] - 1.0) + 2.0
            bias = gate_a_1[..., None] * bias
        logits = logits + bias
    o = torch.softmax(logits, dim=-1) @ v
    return attn.out_proj(o.transpose(1, 2).reshape(B, N, D))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BEATsConfig, index: int):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.self_attn = MultiheadAttention(cfg, index == 0)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d)
        self.deep_alpha = (math.pow(2 * cfg.depth, 0.25) if cfg.deep_norm
                           else 1.0)

    def forward(self, h, pos_bias):
        # post-LN with DeepNorm's residual scaling
        h = self.self_attn_layer_norm(h * self.deep_alpha
                                      + self.self_attn(h, pos_bias))
        m = F.gelu(self.fc1(h))
        return self.final_layer_norm(h * self.deep_alpha + self.fc2(m))


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: BEATsConfig):
        super().__init__()
        self.cfg = cfg
        self.pos_conv = nn.ModuleList([WeightNormConv1d(
            cfg.encoder_embed_dim, cfg.conv_pos, cfg.conv_pos_groups)])
        self.layer_norm = nn.LayerNorm(cfg.encoder_embed_dim)
        self.layers = nn.ModuleList(EncoderLayer(cfg, i)
                                    for i in range(cfg.depth))

    def forward(self, h):
        cfg = self.cfg
        pos = self.pos_conv[0](h.transpose(1, 2)).transpose(1, 2)
        h = self.layer_norm(h + F.gelu(pos))
        N = h.shape[1]
        rel = np.arange(N)[None, :] - np.arange(N)[:, None]
        buckets = torch.as_tensor(_relative_position_bucket(
            rel, cfg.num_buckets, cfg.max_distance), device=h.device)
        table = self.layers[0].self_attn.relative_attention_bias.weight
        pos_bias = table[buckets].permute(2, 0, 1)  # (heads, N, N)
        for layer in self.layers:
            h = layer(h, pos_bias)
        return h


class BEATs(nn.Module):
    """forward(fbank (B, frames, mel_bins), normalised) -> token features
    (B, N, encoder_embed_dim)."""

    def __init__(self, config: BEATsConfig = BEATsConfig()):
        super().__init__()
        self.config = config
        self.patch_embedding = nn.Conv2d(1, config.embed_dim, config.patch,
                                         stride=config.patch, bias=False)
        self.layer_norm = nn.LayerNorm(config.embed_dim)
        self.post_extract_proj = nn.Linear(config.embed_dim,
                                           config.encoder_embed_dim)
        self.encoder = TransformerEncoder(config)
        frozen(self)

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        return beats_encode_fbank(self, fbank, self.config)


def beats_encode_fbank(net: BEATs, fbank: torch.Tensor, cfg: BEATsConfig
                       ) -> torch.Tensor:
    """Normalised fbank (B, frames, mel) -> token features (B, N, D): the
    reference's extract_features after its Kaldi preprocess."""
    with no_tf32():
        Fh = (fbank.shape[1] // cfg.patch) * cfg.patch
        h = net.patch_embedding(fbank[:, None, :Fh].to(torch.float32))
        B, E = h.shape[:2]
        h = h.reshape(B, E, -1).transpose(1, 2)  # (B, N, embed)
        h = net.post_extract_proj(net.layer_norm(h))
        return net.encoder(h)


def beats_apply(net: BEATs, x: torch.Tensor) -> torch.Tensor:
    """x (B, C, T) at cfg.sample_rate -> (B, encoder_embed_dim): the mono
    mix times 2^15, its fbank normalised by the published statistics,
    encoded, the mean over tokens."""
    cfg = net.config
    mono = x.to(torch.float32).mean(dim=1) * (2.0 ** 15)
    with no_tf32():
        fbank = kaldi_fbank(mono, cfg)
    fbank = (fbank - cfg.fbank_mean) / (2.0 * cfg.fbank_std)
    return beats_encode_fbank(net, fbank, cfg).mean(dim=1)


@dataclasses.dataclass
class BEATsModel:
    net: BEATs
    config: BEATsConfig = BEATsConfig()
    embed_dim: int = 768

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return beats_apply(self.net, x)


def init_beats_(net: BEATs, generator: torch.Generator) -> BEATs:
    """The JAX init_beats_params scheme: the patch conv N(0, 0.02^2),
    Xavier-uniform linears (v_proj, out_proj, fc1 and fc2 scaled by
    DeepNorm's beta), the positional conv N(0, 4 / (k D)) as its own g and
    v, the bias table N(0, 0.02^2), zero biases, unit gates and norms."""
    cfg = net.config
    beta = math.pow(8 * cfg.depth, -0.25) if cfg.deep_norm else 1.0

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def linear_(m, gain=1.0):
        a = gain * math.sqrt(6.0 / (m.weight.shape[0] + m.weight.shape[1]))
        m.weight.copy_((torch.rand(m.weight.shape, generator=generator)
                        * 2.0 - 1.0) * a)
        m.bias.zero_()

    with torch.no_grad():
        normal_(net.patch_embedding.weight, 0.02)
        linear_(net.post_extract_proj)
        pc = net.encoder.pos_conv[0]
        normal_(pc.weight_v, math.sqrt(4.0 / (cfg.conv_pos
                                               * cfg.encoder_embed_dim)))
        pc.weight_g.copy_(torch.linalg.vector_norm(pc.weight_v, dim=(0, 1),
                                                   keepdim=True))
        pc.bias.zero_()
        for m in net.modules():
            if isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        for layer in net.encoder.layers:
            sa = layer.self_attn
            linear_(sa.q_proj)
            linear_(sa.k_proj)
            linear_(sa.v_proj, beta)
            linear_(sa.out_proj, beta)
            linear_(layer.fc1, beta)
            linear_(layer.fc2, beta)
            if hasattr(sa, "relative_attention_bias"):
                normal_(sa.relative_attention_bias.weight, 0.02)
            if cfg.gru_rel_pos:
                linear_(sa.grep_linear)
                sa.grep_a.fill_(1.0)
    return net


def beats_config_from_checkpoint(c: dict) -> BEATsConfig:
    """A released checkpoint's ``cfg`` entry -> BEATsConfig."""
    return BEATsConfig(
        embed_dim=c.get("embed_dim", 512),
        encoder_embed_dim=c.get("encoder_embed_dim", 768),
        depth=c.get("encoder_layers", 12),
        heads=c.get("encoder_attention_heads", 12),
        ffn_dim=c.get("encoder_ffn_embed_dim", 3072),
        patch=c.get("input_patch_size", 16),
        conv_pos=c.get("conv_pos", 128),
        conv_pos_groups=c.get("conv_pos_groups", 16),
        num_buckets=c.get("num_buckets", 320),
        max_distance=c.get("max_distance", 800),
        deep_norm=c.get("deep_norm", True),
        gru_rel_pos=c.get("gru_rel_pos", True),
    )


def load_beats_model(ckpt_path: str | None = None, allow_random: bool = False,
                     seed: int = 0, config: BEATsConfig | None = None,
                     device="cuda") -> BEATsModel:
    """BEATs on ``device`` (default the card): the released
    ``BEATs_iter3_plus_AS2M.pt`` at ``ckpt_path`` (its ``model`` entry
    without the tokenizer's and predictor's tensors, its ``cfg``), or with
    ``allow_random`` and no file random weights at ``config`` (default the
    release's) from a ``torch.Generator`` seeded with ``seed``."""
    if ckpt_path and os.path.isfile(ckpt_path):
        dev = resolve_device(device)
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt)
        sd = {k: v for k, v in sd.items()
              if not k.startswith(("predictor", "quantize", "tokenizer"))}
        cfg = (beats_config_from_checkpoint(ckpt["cfg"]) if "cfg" in ckpt
               else BEATsConfig())
        net = BEATs(cfg)
        net.load_state_dict(sd)
        return BEATsModel(net=frozen(net.to(dev)), config=cfg,
                          embed_dim=cfg.encoder_embed_dim)
    if allow_random:
        dev = resolve_device(device)
        cfg = config or BEATsConfig()
        net = init_beats_(BEATs(cfg), torch.Generator().manual_seed(seed))
        return BEATsModel(net=frozen(net.to(dev)), config=cfg,
                          embed_dim=cfg.encoder_embed_dim)
    raise FileNotFoundError(
        "BEATs checkpoint not found; download BEATs_iter3_plus_AS2M.pt and "
        "pass ckpt_path, or use allow_random=True")


def get_beats_embeds(x: torch.Tensor, model: BEATsModel, sample_rate,
                     **kwargs) -> dict[str, torch.Tensor]:
    """{"mono": (B, 768)}: x (B, C, T) resampled to 16 kHz, embedded
    (``beats_apply``), L2-normalised."""
    from st_ito_torch.models.registry import _l2_normalize
    from st_ito_torch.ops.resample import resample

    sr = int(model.config.sample_rate)
    y = x.to(torch.float32)
    if int(sample_rate) != sr:
        y = resample(y, int(sample_rate), sr)
    return {"mono": _l2_normalize(beats_apply(model.net, y))}
