"""The model registry and the embedding API — port of
``st_ito_tpu/models/registry.py``: the AFx-Rep encoder (``ParamModel``,
``load_param_model``, ``get_param_embeds``, ``get_param_embeds_chunked``),
the MFCC feature metric (``MFCCFeatureExtractor``,
``load_mfcc_feature_extractor``, ``get_mfcc_feature_embeds``) and the
baselines' loaders and embeds: Wav2CLIP and VGGish (their modules in
``wav2clip.py`` and ``vggish.py``) and wav2vec2 (transformers' model, from
its local cache only) and the LAION-CLAP metric (``load_clap_model``,
``get_clap_embeds``: the native tower of ``clap_laion.py``, its weights
from a local file or transformers' local cache only). The
MIR features are ``features.py``; the FX-encoder and BEATs are
``encoders.py`` and ``beats.py``."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config, init_cnn14_
from st_ito_torch.models.convert import (cnn14_state_dict_from_jax,
                                         load_torch_checkpoint)
from st_ito_torch.models.vggish import get_vggish_embeds  # noqa: F401
from st_ito_torch.models.wav2clip import get_wav2clip_embeds  # noqa: F401
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


def export_encoder_npz(state_dict: dict, path: str,
                       config: Cnn14Config | None = None) -> None:
    """Save a Cnn14 ``state_dict`` (and its config) in the JAX package's
    npz layout, which ``load_param_model`` of either package serves:
    dotted keys without the BatchNorm step counters, the config as JSON
    under ``__config__``."""
    flat = {k: v.detach().cpu().numpy() for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")}
    if config is not None:
        flat["__config__"] = np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_param_model(ckpt_path: str | None = None, allow_random: bool = False,
                     seed: int = 0, device="cuda") -> ParamModel:
    """Load the AFx-Rep encoder onto ``device`` (default the card).

    Search order, as in the JAX package: the explicit ckpt_path, then
    ./tmp/afx-rep.{npz,ckpt}, then $STITO_CKPT_DIR/afx-rep.{npz,ckpt}. A
    Lightning ``.ckpt`` is converted (``convert.load_torch_checkpoint``)
    and cached as ``.npz`` beside it where that directory is writable.
    With allow_random=True and no checkpoint, the weights are drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    candidates = [] if ckpt_path is None else [ckpt_path]
    for root in (os.path.join(os.getcwd(), "tmp"),
                 os.environ.get("STITO_CKPT_DIR", "")):
        if root:
            candidates.append(os.path.join(root, "afx-rep.npz"))
            candidates.append(os.path.join(root, "afx-rep.ckpt"))
    for path in candidates:
        if not os.path.isfile(path):
            continue
        if path.endswith(".npz"):
            return _model_from_npz(path, dev)
        sd, config = load_torch_checkpoint(path)
        try:
            export_encoder_npz(sd, os.path.splitext(path)[0] + ".npz",
                               config)
        except OSError:
            pass
        net = Cnn14(config)
        net.load_state_dict(sd)
        return ParamModel(net=net.to(dev), config=config,
                          embed_dim=config.embed_dim)
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


# ------------------------------------------- wav2vec2, Wav2CLIP and VGGish


@dataclasses.dataclass
class Wav2Vec2Handle:
    model: object
    embed_dim: int = 768


def load_wav2vec2_model(model_id: str = "facebook/wav2vec2-base",
                        device="cuda") -> Wav2Vec2Handle:
    """transformers' Wav2Vec2Model from the local Hugging Face cache only
    (no download is attempted), on ``device``. Raises FileNotFoundError
    where transformers or the cached weights are missing."""
    try:
        from transformers import Wav2Vec2Model

        model = Wav2Vec2Model.from_pretrained(model_id, local_files_only=True)
    except (OSError, ImportError) as e:
        raise FileNotFoundError(
            f"wav2vec2 weights for {model_id} not in the local Hugging Face "
            f"cache. Original error: {e}") from e
    model.eval()
    model.requires_grad_(False)
    return Wav2Vec2Handle(model=model.to(resolve_device(device)))


def get_wav2vec2_embeds(x: torch.Tensor, model: Wav2Vec2Handle,
                        sample_rate: float, **kwargs) -> dict:
    """{"mono": (B, 768)}: x resampled to 16 kHz, mixed to mono, the mean
    of the last hidden states, L2-normalised."""
    from st_ito_torch.models.cnn14 import no_tf32

    x = x.to(torch.float32)
    if int(sample_rate) != 16000:
        x = resample(x, int(sample_rate), 16000)
    with no_tf32(), torch.no_grad():
        out = model.model(x.mean(dim=1)).last_hidden_state
    return {"mono": _l2_normalize(out.mean(dim=1))}


def load_wav2clip_model(ckpt_path: str | None = "checkpoints/Wav2CLIP.pt",
                        allow_random: bool = False, device="cuda"):
    """Wav2CLIP (``wav2clip.py``) from the release checkpoint's usual
    path."""
    from st_ito_torch.models.wav2clip import load_wav2clip_model as _load

    return _load(ckpt_path=ckpt_path, allow_random=allow_random,
                 device=device)


def load_vggish_model(ckpt_path: str | None = "checkpoints/vggish.pth",
                      pca_path: str | None = (
                          "checkpoints/vggish_pca_params.pth"),
                      allow_random: bool = False, device="cuda"):
    """VGGish (``vggish.py``) from the upstream files' usual paths."""
    from st_ito_torch.models.vggish import load_vggish_model as _load

    return _load(ckpt_path=ckpt_path, pca_path=pca_path,
                 allow_random=allow_random, device=device)


# ------------------------------------------------------------- CLAP metric


def load_clap_model(model_id: str = "laion/clap-htsat-unfused",
                    ckpt_path: str | None = (
                        "checkpoints/clap-htsat-unfused.pt"),
                    device="cuda"):
    """LAION-CLAP's native tower (``clap_laion.py``) on ``device`` (default
    the card), its weights from a transformers ``ClapModel`` state_dict at
    ``ckpt_path``, else from transformers' ``ClapModel`` in the local
    Hugging Face cache (``local_files_only=True``: no download is
    attempted); without either, FileNotFoundError. A state_dict whose
    names do not fit the tower raises as ``load_state_dict`` does."""
    from st_ito_torch.models.clap_laion import (ClapAudioTower,
                                                ClapLaionModel,
                                                hf_state_dict,
                                                load_clap_laion_model)
    from st_ito_torch.models.encoders import frozen

    try:
        return load_clap_laion_model(ckpt_path=ckpt_path, device=device)
    except FileNotFoundError:
        pass
    try:
        from transformers import ClapModel

        m = ClapModel.from_pretrained(model_id, local_files_only=True)
    except (OSError, ImportError) as e:
        raise FileNotFoundError(
            f"CLAP weights for {model_id} not available locally. "
            f"Pre-populate the Hugging Face cache, drop a state_dict at "
            f"{ckpt_path}, or use --metric param/mfcc. Original error: {e}"
        ) from e
    net = ClapAudioTower()
    net.load_state_dict(hf_state_dict(m.state_dict()))
    return ClapLaionModel(net=frozen(net.to(resolve_device(device))))


def get_clap_embeds(x: torch.Tensor, model, sample_rate: float,
                    midside: bool = False, **kwargs
                    ) -> dict[str, torch.Tensor]:
    """CLAP audio embeddings of x (bs, chs, T) by the native tower on x's
    device, L2-normalised: {"mono"}, or with ``midside`` on stereo {"mid",
    "side"} of x0 + x1 and x0 - x1 (``clap_laion.get_clap_laion_embeds``).
    The ITO engine scores it as any other embed: the port has no trace
    barrier that would send it to the host."""
    from st_ito_torch.models.clap_laion import get_clap_laion_embeds

    return get_clap_laion_embeds(x, model, sample_rate, midside=midside,
                                 **kwargs)
