"""AFx-Rep model loading and the embedding API — port of
``st_ito_tpu/models/registry.py``'s ``ParamModel``, ``load_param_model``,
``get_param_embeds``, ``get_param_embeds_chunked`` and the MFCC feature
metric (``MFCCFeatureExtractor``, ``load_mfcc_feature_extractor``,
``get_mfcc_feature_embeds``). The MIR features are ``features.py``; the
other encoders (CLAP, ...) are ROADMAP §1 item 11."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config, init_cnn14_
from st_ito_torch.models.convert import cnn14_state_dict_from_jax
from st_ito_torch.ops.resample import resample
from st_ito_torch.ops.stft import mfcc as _mfcc
from st_ito_torch.utils import resolve_device


@dataclasses.dataclass
class ParamModel:
    """AFx-Rep model handle: the Cnn14 module and its config. ``config``
    may differ from ``net.config`` in ``compute_dtype`` only (the fitness
    function picks its own precision); ``__call__`` uses ``config``."""

    net: Cnn14
    config: Cnn14Config
    embed_dim: int = 512

    def __call__(self, x: torch.Tensor):
        return self.net(x, compute_dtype=self.config.compute_dtype)


def _model_from_npz(path: str, device) -> ParamModel:
    """Read the ``export_encoder_npz`` layout: dotted keys plus an optional
    JSON ``__config__``."""
    with np.load(path) as data:
        config = Cnn14Config()
        if "__config__" in data.files:
            config = Cnn14Config(**json.loads(bytes(data["__config__"])))
        params = {k: data[k] for k in data.files if k != "__config__"}
    net = Cnn14(config)
    net.load_state_dict(cnn14_state_dict_from_jax(params))
    return ParamModel(net=net.to(device), config=config,
                      embed_dim=config.embed_dim)


def load_param_model(ckpt_path: str | None = None, allow_random: bool = False,
                     seed: int = 0, device="cuda") -> ParamModel:
    """Load the AFx-Rep encoder onto ``device`` (default the card).

    Search order: explicit ckpt_path -> ./tmp/afx-rep.npz ->
    $STITO_CKPT_DIR/afx-rep.npz. A torch ``.ckpt`` is converted by the JAX
    package's converter, which is not ported (ROADMAP §1 item 11): export
    it to npz first. With allow_random=True and no checkpoint, the weights
    are drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    candidates = [] if ckpt_path is None else [ckpt_path]
    for root in (os.path.join(os.getcwd(), "tmp"),
                 os.environ.get("STITO_CKPT_DIR", "")):
        if root:
            candidates.append(os.path.join(root, "afx-rep.npz"))
    for path in candidates:
        if not os.path.isfile(path):
            continue
        if not path.endswith(".npz"):
            raise NotImplementedError(
                f"{path}: only the npz layout loads in st_ito_torch; the "
                f".ckpt converter is ROADMAP §1 item 11")
        return _model_from_npz(path, dev)
    if allow_random:
        config = Cnn14Config()
        net = init_cnn14_(Cnn14(config), torch.Generator().manual_seed(seed))
        return ParamModel(net=net.to(dev), config=config,
                          embed_dim=config.embed_dim)
    raise FileNotFoundError(
        "afx-rep checkpoint not found (looked in: " + ", ".join(candidates)
        + "); pass allow_random=True for a random-weight encoder")


def _l2_normalize(e: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True), eps)


def get_param_embeds(x: torch.Tensor, model: ParamModel, sample_rate: float,
                     peak_normalize: bool = True, dropout: float = 0.0,
                     generator: torch.Generator | None = None
                     ) -> dict[str, torch.Tensor]:
    """AFx-Rep embeddings of x (bs, chs, T) -> {"mid": (bs, D), "side":
    (bs, D)}, L2-normalised. x must be on the model's device; at another
    sample rate than the encoder's it is resampled first (by FFT).

    Embedding dropout: with ``dropout`` > 0 and a ``generator`` (a
    ``torch.Generator`` on x's device), each of mid and side keeps an
    element with probability 1 - dropout, scaled by 1 / (1 - dropout),
    before the normalisation, as the JAX package draws its masks from a key
    (``st_ito_tpu/models/registry.py:139-143``); without a generator no
    element is dropped, as there without a key."""
    x = x.to(torch.float32)
    if int(sample_rate) != int(model.config.sample_rate):
        x = resample(x, int(sample_rate), int(model.config.sample_rate))
    if peak_normalize:
        peak = torch.amax(x.abs(), dim=tuple(range(1, x.ndim)), keepdim=True)
        x = x / torch.clamp_min(peak, 1e-8)
    mid, side = model(x)
    if dropout > 0.0 and generator is not None:
        keep = 1.0 - dropout

        def drop(e):
            mask = torch.rand(e.shape, generator=generator, device=e.device,
                              dtype=torch.float32) < keep
            return torch.where(mask, e / keep, 0.0)

        mid, side = drop(mid), drop(side)
    return {"mid": _l2_normalize(torch.nan_to_num(mid)),
            "side": _l2_normalize(torch.nan_to_num(side))}


# get_param_embeds peak-normalises its own input, so a fitness function may
# skip the renderer's output normalisation: embed(y / max|y|) == embed(y).
get_param_embeds.peak_normalizes_input = True


def embed_in_chunks(embed, x: torch.Tensor, model, sample_rate: float,
                    chunk_len: int, hop: int | None = None, **kwargs
                    ) -> dict[str, torch.Tensor]:
    """Long-audio embedding through any ``embed``: cut x (bs, chs, T) into
    chunks of ``chunk_len`` every ``hop`` samples (default: back to back; a
    tail shorter than a chunk is left out), embed every chunk as one batch,
    average each item's chunks and L2-normalise again. At T <= chunk_len it
    is ``embed`` itself."""
    bs, chs, T = x.shape
    hop = hop or chunk_len
    if T <= chunk_len:
        return embed(x, model, sample_rate, **kwargs)
    n_chunks = (T - chunk_len) // hop + 1
    chunks = x.unfold(-1, chunk_len, hop).transpose(1, 2).reshape(
        bs * n_chunks, chs, chunk_len)
    e = embed(chunks, model, sample_rate, **kwargs)
    return {k: _l2_normalize(v.reshape(bs, n_chunks, -1).mean(dim=1))
            for k, v in e.items()}


def get_param_embeds_chunked(x: torch.Tensor, model: ParamModel,
                             sample_rate: float, chunk_len: int = 262144,
                             hop: int | None = None, **kwargs
                             ) -> dict[str, torch.Tensor]:
    """``get_param_embeds`` over chunks of long audio (``embed_in_chunks``)."""
    return embed_in_chunks(get_param_embeds, x, model, sample_rate,
                           chunk_len, hop, **kwargs)


# each chunk is peak-normalised on its own, so the chunked embed is
# scale-invariant as well
get_param_embeds_chunked.peak_normalizes_input = True


# ------------------------------------------------------- MFCC feature metric


@dataclasses.dataclass
class MFCCFeatureExtractor:
    sample_rate: int = 48000
    n_mfcc: int = 25
    embed_dim: int = 75


def load_mfcc_feature_extractor(use_gpu: bool = False
                                ) -> MFCCFeatureExtractor:
    return MFCCFeatureExtractor()


def get_mfcc_feature_embeds(x: torch.Tensor, model: MFCCFeatureExtractor,
                            sample_rate: float, midside: bool = False,
                            **kwargs) -> dict[str, torch.Tensor]:
    """{"mono": (bs, 3 * n_mfcc [* 2 with midside])}: each coefficient's
    mean, standard deviation and maximum over the frames of x (bs, chs, T)
    (its channel mean, or mid and side with ``midside`` on stereo),
    L2-normalised. Note that ``mfcc``'s 80 dB floor is taken from the
    maximum over the whole batch, as in the JAX package."""
    x = x.to(torch.float32)
    bs, chs, _ = x.shape
    if int(sample_rate) != model.sample_rate:
        x = resample(x, int(sample_rate), model.sample_rate)
    if chs == 2 and midside:
        x = torch.stack([x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]], dim=1)
    else:
        x = x.mean(dim=1, keepdim=True)
    M = _mfcc(x, model.sample_rate, n_mfcc=model.n_mfcc).transpose(-1, -2)
    feats = torch.cat([M.mean(dim=-1), M.std(dim=-1, correction=0),
                       M.amax(dim=-1)], dim=-1).reshape(bs, -1)
    return {"mono": _l2_normalize(feats)}
