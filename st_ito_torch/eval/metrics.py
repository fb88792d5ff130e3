"""The metric registry — port of ``st_ito_tpu/eval/metrics.py``: each
metric is a (load_fn, embed_fn) pair, ``load_metric`` loads one, and
``style_similarity`` is the mean cosine over the embedding heads that
scores outputs against targets. "param" (the AFx-Rep Cnn14), "mfcc" and
"mir" are ported; the checkpoint-gated baselines (clap, fx-encoder, beats,
wav2vec2, wav2clip, vggish) raise, naming ROADMAP §1 item 11."""

from __future__ import annotations

import torch

from st_ito_torch.features import (get_mir_feature_embeds,
                                   load_mir_feature_extractor)
from st_ito_torch.models.registry import (get_mfcc_feature_embeds,
                                          get_param_embeds,
                                          load_mfcc_feature_extractor,
                                          load_param_model)


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"the {name} metric's encoder is not ported to st_ito_torch yet "
            f"(ROADMAP §1 item 11)")

    return refuse, refuse


METRICS = {
    "param": (load_param_model, get_param_embeds),
    "mfcc": (load_mfcc_feature_extractor, get_mfcc_feature_embeds),
    "mir": (load_mir_feature_extractor, get_mir_feature_embeds),
    **{name: _not_ported(name) for name in (
        "clap", "fx-encoder", "beats", "wav2vec2", "wav2clip", "vggish")},
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
