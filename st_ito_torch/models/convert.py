"""Weight conversion: the AFx-Rep Lightning checkpoint into the port's
Cnn14, and the JAX package's parameters of every encoder into the port's
modules.

The AFx-Rep ``.ckpt`` converter is the port of
``st_ito_tpu/models/convert.py``'s: strip the Lightning ``encoder.``
prefix, drop torchlibrosa's STFT and mel buffers (the front end is
computed) and the BatchNorm step counters, keep torch's layouts, read a
``config.yaml`` beside the checkpoint into the ``Cnn14Config``.

The JAX models keep their parameters as nested dicts (and lists) whose
dotted paths are, for the Cnn14, the dsTCN, VGGish, HTS-AT, the CLAP-ft
encoder and DeepGCN, the torch ``state_dict`` names; the FX-encoder,
Wav2CLIP, BEATs and LAION-CLAP pytrees differ from their releases' names
in documented ways (``*_state_dict_from_jax`` maps each). Conv weights are
OIHW / OIW in both.
"""

from __future__ import annotations

import math
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


def htsat_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX HTS-AT pytree -> a ``state_dict`` for ``htsat.HTSAT`` (the
    same dotted names)."""
    return _tensors(flatten_params(params))


def clap_audio_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX CLAP-ft pytree (``tower``, ``projection``) -> a
    ``state_dict`` for ``clap.CLAPAudio`` (the same dotted names)."""
    return _tensors(flatten_params(params))


def deepgcn_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX DeepGCN pytree -> a ``state_dict`` for ``gcn.DeepGCN`` (the
    same dotted names, each BatchNorm's step counter added)."""
    return _tensors(flatten_params(params))


# the JAX LAION-CLAP block's names -> transformers'
_CLAP_BLOCK_NAMES = {
    "ln1": "layernorm_before", "q": "attention.self.query",
    "k": "attention.self.key", "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "rel_bias": "attention.self.relative_position_bias_table",
    "ln2": "layernorm_after", "fc1": "intermediate.dense",
    "fc2": "output.dense"}


def clap_laion_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX LAION-CLAP pytree -> transformers' names
    (``audio_model.audio_encoder.*``, ``audio_projection.*``) for
    ``clap_laion.ClapAudioTower``, with each block's relative position
    index and the BatchNorm's step counter; the inverse of the JAX
    package's ``convert_clap_laion_state_dict``."""
    from st_ito_torch.models.clap_laion import _rel_index

    enc = "audio_model.audio_encoder."
    flat = {}
    for k, v in flatten_params(params).items():
        parts = k.split(".")
        if parts[0] == "layers" and parts[2] == "blocks":
            parts[4] = _CLAP_BLOCK_NAMES[parts[4]]
        elif parts[0] == "proj":
            flat["audio_projection." + ".".join(parts[1:])] = v
            continue
        flat[enc + ".".join(parts)] = v
    sd = _tensors(flat)
    for k in [k for k in sd if k.endswith("relative_position_bias_table")]:
        window = (math.isqrt(sd[k].shape[0]) + 1) // 2
        sd[k[:-len("bias_table")] + "index"] = torch.from_numpy(
            _rel_index(window, window))
    return sd


# ------------------------------------------------- trained states


_ENCODER_FROM_JAX = {
    "cnn14": cnn14_state_dict_from_jax, "dstcn": dstcn_state_dict_from_jax,
    "gcn": deepgcn_state_dict_from_jax, "htsat": htsat_state_dict_from_jax,
    "clap": clap_audio_state_dict_from_jax,
    "clap-laion": clap_laion_state_dict_from_jax}


def _prefixed(sd: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def param_estimator_state_dict_from_jax(params: dict,
                                        encoder_type: str = "cnn14"
                                        ) -> dict[str, torch.Tensor]:
    """The JAX ``ParamTrainState.params`` ({"encoder", "instance_estimator",
    ["preset_estimator"], ["discriminator"]}) -> a ``state_dict`` for
    ``train.param.ParamEstimator``: the encoder by its converter, the
    heads by name."""
    sd = _prefixed(_ENCODER_FROM_JAX[encoder_type](params["encoder"]),
                   "encoder")
    for head in ("instance_estimator", "preset_estimator", "discriminator"):
        if head in params:
            sd.update(_prefixed(_tensors(flatten_params(params[head])), head))
    return sd


def style_system_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX ``StyleTrainState.params`` ({"encoder", "estimator"}, the
    regressor or the stacked classifier) -> a ``state_dict`` for
    ``train.style.StyleModel``."""
    sd = _prefixed(cnn14_state_dict_from_jax(params["encoder"]), "encoder")
    sd.update(_prefixed(_tensors(flatten_params(params["estimator"])),
                        "estimator"))
    return sd


def unflatten_params(flat: dict) -> dict:
    """{"a.0.c": array} -> nested dicts, a level whose keys are all
    indices a list: the JAX pytrees' layout."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, leaf = key.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _arrays(sd: dict) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if not k.endswith(("num_batches_tracked",
                               "relative_position_index"))}


def _clap_laion_to_jax(flat: dict) -> dict:
    """transformers' names -> the JAX LAION-CLAP pytree's (the inverse of
    ``clap_laion_state_dict_from_jax``)."""
    back = {v: k for k, v in _CLAP_BLOCK_NAMES.items()}
    enc = "audio_model.audio_encoder."
    out = {}
    for k, v in flat.items():
        if k.startswith("audio_projection."):
            out["proj." + k[len("audio_projection."):]] = v
            continue
        parts = k[len(enc):].split(".")
        if parts[0] == "layers" and parts[2] == "blocks":
            rest = ".".join(parts[4:])
            for name, jax_name in back.items():
                if rest == name:  # a leaf of its own (the bias table)
                    parts = parts[:4] + [jax_name]
                    break
                if rest.startswith(name + "."):
                    parts = parts[:4] + [jax_name, rest[len(name) + 1:]]
                    break
        out[".".join(parts)] = v
    return out


def param_estimator_params_to_jax(state_dict: dict,
                                  encoder_type: str = "cnn14") -> dict:
    """The other direction: a ``ParamEstimator`` state_dict -> the JAX
    params pytree (numpy leaves) that ``st_ito_tpu``'s trainer holds. The
    encoders other than the LAION-CLAP tower keep the JAX dotted names."""
    flat = _arrays(state_dict)
    enc = {k[len("encoder."):]: v for k, v in flat.items()
           if k.startswith("encoder.")}
    if encoder_type == "clap-laion":
        enc = _clap_laion_to_jax(enc)
    elif encoder_type not in _ENCODER_FROM_JAX:
        raise ValueError(f"unknown encoder_type: {encoder_type}")
    tree = unflatten_params({k: v for k, v in flat.items()
                             if not k.startswith("encoder.")})
    tree["encoder"] = unflatten_params(enc)
    return tree


def style_system_params_to_jax(state_dict: dict) -> dict:
    """A ``StyleModel`` state_dict -> the JAX style params pytree."""
    return unflatten_params(_arrays(state_dict))


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
