"""Weight conversion: the AFx-Rep Lightning checkpoint into the port's
Cnn14, and the JAX package's parameters of every encoder into the port's
modules.

The AFx-Rep ``.ckpt`` converter is the port of
``st_ito_tpu/models/convert.py``'s: strip the Lightning ``encoder.``
prefix, drop torchlibrosa's STFT and mel buffers (the front end is
computed) and the BatchNorm step counters, keep torch's layouts, read a
``config.yaml`` beside the checkpoint into the ``Cnn14Config``.

The JAX models keep their parameters as nested dicts (and lists) whose
dotted paths are, for the Cnn14, the dsTCN and VGGish, the torch
``state_dict`` names; the FX-encoder, Wav2CLIP and BEATs pytrees differ
from their releases' names in documented ways (``*_state_dict_from_jax``
maps each). Conv weights are OIHW / OIW in both.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from st_ito_torch.models.cnn14 import Cnn14Config

_SKIP_SUBSTRINGS = (
    "spectrogram_extractor",
    "logmel_extractor",
    "spec_augmenter",
    "num_batches_tracked",
)


def flatten_params(params, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts and lists of arrays -> {"a.0.c": array}."""
    items = (params.items() if isinstance(params, dict)
             else ((str(i), v) for i, v in enumerate(params)))
    flat = {}
    for k, v in items:
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _tensors(flat: dict) -> dict[str, torch.Tensor]:
    """Arrays (or CPU tensors) as float32 CPU tensors, plus the step
    counter of every BatchNorm (a key ending ``running_var``), which only
    torch keeps."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flat.items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def cnn14_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX Cnn14 pytree (nested dict of arrays) -> a ``state_dict``
    for ``st_ito_torch.models.cnn14.Cnn14`` (float32, on the CPU)."""
    return _tensors(flatten_params(params))


def dstcn_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX dsTCN pytree -> a ``state_dict`` for ``encoders.DsTCN``
    (the same dotted names)."""
    return _tensors(flatten_params(params))


def fx_encoder_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX FX-encoder pytree (``encoder.{i}.conv{1,2}.{weight,bias,
    bn.*}``) -> the release's names (``encoder.{i}.conv{1,2}.conv1d.
    {conv1d,batch_norm}.*``) for ``encoders.FXEncoder``."""
    flat = {}
    for k, v in flatten_params(params).items():
        head, _, leaf = k.rpartition(".")
        if head.endswith(".bn"):
            k = head[:-len(".bn")] + ".conv1d.batch_norm." + leaf
        else:
            k = head + ".conv1d.conv1d." + leaf
        flat[k] = v
    return _tensors(flat)


def vggish_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX VGGish pytree -> a ``state_dict`` for ``vggish.VGGish``
    (``postprocess=True`` where the pytree holds the PCA tensors)."""
    sd = _tensors(flatten_params(params))
    if "pca_means" in sd:
        sd["pca_means"] = sd["pca_means"].reshape(-1)
    return sd


def wav2clip_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX Wav2CLIP pytree (bare torchvision names, ``transform.{i}``)
    -> the release's names for ``wav2clip.Wav2Clip``."""
    from st_ito_torch.models.wav2clip import release_state_dict

    return release_state_dict(_tensors(flatten_params(params)))


def beats_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX BEATs pytree, whose positional conv holds the folded weight
    -> the release's names for ``beats.BEATs``, that weight as its own
    direction ``weight_v`` with ``weight_g`` its norm."""
    sd = _tensors(flatten_params(params))
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_v"] = w
    sd["encoder.pos_conv.0.weight_g"] = torch.linalg.vector_norm(
        w, dim=(0, 1), keepdim=True)
    return sd


# ------------------------------------------------- the AFx-Rep checkpoint


def torch_state_dict_to_params(state_dict: dict) -> dict[str, torch.Tensor]:
    """A flat torch ``state_dict`` (its prefix already stripped) without
    torchlibrosa's front-end buffers, SpecAugment's and the BatchNorm step
    counters, as float32 CPU tensors."""
    out = {}
    for key, value in state_dict.items():
        if any(s in key for s in _SKIP_SUBSTRINGS):
            continue
        out[key] = torch.as_tensor(
            value.detach().cpu() if hasattr(value, "detach") else value,
            dtype=torch.float32)
    return out


def strip_prefix(state_dict: dict, prefix: str = "encoder.") -> dict:
    """The entries under ``prefix``, the prefix removed."""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def load_torch_checkpoint(ckpt_path: str
                          ) -> tuple[dict[str, torch.Tensor], Cnn14Config]:
    """An AFx-Rep Lightning checkpoint (``afx-rep.ckpt``) -> (a
    ``state_dict`` for the port's ``Cnn14``, its ``Cnn14Config``). A
    ``config.yaml`` beside the checkpoint sets the config from its
    ``model.init_args.encoder.init_args`` (PyYAML is imported only then,
    and its absence raises); without one the config is the default."""
    checkpoint = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state_dict = checkpoint.get("state_dict", checkpoint)
    sd = _tensors(torch_state_dict_to_params(
        strip_prefix(state_dict, "encoder.")))

    config = Cnn14Config()
    config_path = os.path.join(os.path.dirname(ckpt_path), "config.yaml")
    if os.path.isfile(config_path):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"{config_path} sets the checkpoint's Cnn14Config and reading "
                f"it needs PyYAML, which is not installed") from e
        with open(config_path) as f:
            cfg = yaml.safe_load(f)
        try:
            init_args = cfg["model"]["init_args"]["encoder"]["init_args"]
            config = Cnn14Config(**init_args)
        except (KeyError, TypeError):
            pass
    return sd, config
