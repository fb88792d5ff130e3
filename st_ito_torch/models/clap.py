"""The CLAP-style audio encoder as a trainable pretext option — port of
``st_ito_tpu/models/clap.py`` (``cfg/pretext-clap-ft.yaml``): the HTS-AT
tower (``htsat.py``) with a linear projection to the CLAP embedding width,
applied to the halved mid and side signals in one batched tower pass (the
"-ft" role). The parameter names are the JAX pytree's: ``tower.*`` and
``projection.{weight,bias}``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.models.htsat import HTSAT, HTSATConfig, init_htsat_


@dataclasses.dataclass(frozen=True)
class CLAPAudioConfig:
    embed_dim: int = 512  # the CLAP joint space's width
    tower: HTSATConfig = HTSATConfig(embed_dim=768)  # the HTS-AT tower


class CLAPAudio(nn.Module):
    """forward(x (B, C, T)) -> (mid_embed, side_embed), (B, embed_dim)
    each: stereo split into (x0 + x1) / 2 and (x0 - x1) / 2, both through
    one tower pass, each projected; mono input gives its embedding as both
    heads."""

    def __init__(self, config: CLAPAudioConfig = CLAPAudioConfig()):
        super().__init__()
        self.config = config
        self.tower = HTSAT(config.tower)
        self.projection = nn.Linear(config.tower.embed_dim, config.embed_dim)

    def forward(self, x: torch.Tensor):
        x = x.to(torch.float32)
        if x.shape[1] == 2:
            B = x.shape[0]
            both = torch.cat([(x[:, :1] + x[:, 1:]) / 2.0,
                              (x[:, :1] - x[:, 1:]) / 2.0])
            e, _ = self.tower(both)
            e_mid, e_side = e[:B], e[B:]
        else:
            e_mid, _ = self.tower(x)
            e_side = e_mid
        with no_tf32():
            return self.projection(e_mid), self.projection(e_side)


def init_clap_audio_(net: CLAPAudio, generator: torch.Generator
                     ) -> CLAPAudio:
    """The JAX init scheme: the tower's (``init_htsat_``), the projection
    Xavier-uniform with a zero bias."""
    init_htsat_(net.tower, generator)
    w = net.projection.weight
    a = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * a)
        net.projection.bias.zero_()
    return net
