"""The metric registry — port of ``st_ito_tpu/eval/metrics.py``: each
metric is a (load_fn, embed_fn) pair, ``load_metric`` loads one, and
``style_similarity`` is the mean cosine over the embedding heads that
scores outputs against targets. "param" (the AFx-Rep Cnn14), "mfcc",
"mir" and the checkpoint-gated baselines "fx-encoder", "beats",
"wav2vec2", "wav2clip", "vggish" and "clap" are ported: each baseline's
loader reads its weights from the JAX package's path (CLAP's, or
transformers' local cache) and raises FileNotFoundError where they are
missing."""

from __future__ import annotations

import torch

from st_ito_torch.features import (get_mir_feature_embeds,
                                   load_mir_feature_extractor)
from st_ito_torch.models.beats import get_beats_embeds, load_beats_model
from st_ito_torch.models.encoders import (get_fx_encoder_embeds,
                                          load_fx_encoder_model)
from st_ito_torch.models.registry import (get_clap_embeds,
                                          get_mfcc_feature_embeds,
                                          get_param_embeds,
                                          get_vggish_embeds,
                                          get_wav2clip_embeds,
                                          get_wav2vec2_embeds,
                                          load_clap_model,
                                          load_mfcc_feature_extractor,
                                          load_param_model,
                                          load_vggish_model,
                                          load_wav2clip_model,
                                          load_wav2vec2_model)


def _load_fx_encoder():
    return load_fx_encoder_model(ckpt_path="checkpoints/FXencoder_ps.pt")


def _load_beats():
    return load_beats_model(ckpt_path="checkpoints/BEATs_iter3_plus_AS2M.pt")


METRICS = {
    "param": (load_param_model, get_param_embeds),
    "mfcc": (load_mfcc_feature_extractor, get_mfcc_feature_embeds),
    "mir": (load_mir_feature_extractor, get_mir_feature_embeds),
    "clap": (load_clap_model, get_clap_embeds),
    "fx-encoder": (_load_fx_encoder, get_fx_encoder_embeds),
    "beats": (_load_beats, get_beats_embeds),
    "wav2vec2": (load_wav2vec2_model, get_wav2vec2_embeds),
    "wav2clip": (load_wav2clip_model, get_wav2clip_embeds),
    "vggish": (load_vggish_model, get_vggish_embeds),
}


def load_metric(name: str, **kwargs):
    """(model, embed_fn) of a metric; ``kwargs`` reach the param model's
    loader (``allow_random``, ``device``, ...) only."""
    load_fn, embed_fn = METRICS[name]
    model = load_fn(**kwargs) if name == "param" else load_fn()
    return model, embed_fn


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
    return num / torch.clamp_min(den, 1e-12)


def style_similarity(embeds_a: dict, embeds_b: dict) -> torch.Tensor:
    """The mean cosine similarity over the embedding heads, (bs,)."""
    sims = [cosine(embeds_a[k], embeds_b[k]) for k in sorted(embeds_a)]
    return torch.stack(sims, dim=0).mean(dim=0)
