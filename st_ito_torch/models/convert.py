"""Carry the JAX package's Cnn14 weights across.

The JAX Cnn14 keeps its parameters as a nested dict whose dotted paths are
the torch ``state_dict`` names, with conv weights in OIHW as torch has
them; the port's ``Cnn14`` module uses the same names. Converting is
therefore a flatten plus the BatchNorm step counters, which only torch
keeps.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_params(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a.b.c": array}."""
    flat = {}
    for k, v in params.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def cnn14_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX Cnn14 pytree (nested dict of arrays) -> a ``state_dict``
    for ``st_ito_torch.models.cnn14.Cnn14`` (float32, on the CPU)."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flatten_params(params).items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd
