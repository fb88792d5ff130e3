"""Preset discovery by randomised parameter-space sampling with rejection —
port of ``st_ito_tpu/data/presets.py``, the same numpy draws in the same
order, each try rendered by the port's per-candidate ``build_render_fn``
on ``device`` (default the card).

A preset is kept only if its render is non-silent AND audibly different
from the input and from the presets already accepted (reference:
scripts/data/vst_presets.py:124-218). An *instance* is one effect from the
registry; each gets ``num_presets`` accepted parameter vectors, and the
(instance, preset) pair is the pretext classification target.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
from st_ito_torch.chain.executor import build_render_fn
from st_ito_torch.utils import resolve_device


@dataclasses.dataclass
class PresetBank:
    """instance_names[i] is the effect key; presets (I, P, max_params) padded
    raw vectors; param_counts[i] actual widths."""

    instance_names: list[str]
    presets: np.ndarray
    param_counts: np.ndarray

    @property
    def num_instances(self) -> int:
        return len(self.instance_names)

    @property
    def num_presets(self) -> int:
        return self.presets.shape[1]

    def chain_for(self, instance_idx: int) -> ChainSpec:
        name = self.instance_names[instance_idx]
        return ChainSpec(stages=(EFFECT_REGISTRY[name](),), with_bypass=False)

    def save(self, path: str) -> None:
        np.savez(
            path,
            instance_names=np.asarray(self.instance_names),
            presets=self.presets,
            param_counts=self.param_counts,
        )

    @classmethod
    def load(cls, path: str) -> "PresetBank":
        d = np.load(path, allow_pickle=False)
        return cls(
            instance_names=[str(s) for s in d["instance_names"]],
            presets=d["presets"],
            param_counts=d["param_counts"],
        )


def probe_signal(probe_len: int, sample_rate: int) -> np.ndarray:
    """The rejection probe: four enveloped partials, peak 0.7, (T,)."""
    t = np.arange(probe_len) / sample_rate
    probe = sum(
        np.sin(2 * np.pi * f * t) * a
        for f, a in [(110, 1.0), (440, 0.5), (1760, 0.3), (7040, 0.2)]
    )
    probe *= np.exp(-((t % 0.25) / 0.1))
    return (probe / np.abs(probe).max() * 0.7).astype(np.float32)


def _db(v) -> float:
    return 20 * np.log10(max(np.sqrt(np.mean(v ** 2)), 1e-10))


def sample_preset_bank(
    effect_names: list[str] | None = None,
    num_presets: int = 10,
    sample_rate: int = 48000,
    probe_len: int = 32768,
    seed: int = 0,
    silence_db: float = -48.0,
    min_diff_db: float = -30.0,
    max_tries: int = 200,
    device="cuda",
) -> PresetBank:
    """Sample presets per effect with silence + difference rejection."""
    dev = resolve_device(device)
    if effect_names is None:
        effect_names = sorted(EFFECT_REGISTRY.keys())

    rng = np.random.default_rng(seed)
    probe = probe_signal(probe_len, sample_rate)
    x_np = np.stack([probe, probe])  # (2, T)
    x = torch.from_numpy(x_np).to(dev)

    max_params = max(
        len(EFFECT_REGISTRY[n]().params) for n in effect_names
    )
    presets = np.zeros((len(effect_names), num_presets, max_params), np.float32)
    counts = np.zeros(len(effect_names), np.int32)

    for i, name in enumerate(effect_names):
        chain = ChainSpec(stages=(EFFECT_REGISTRY[name](),), with_bypass=False)
        render = build_render_fn(chain, sample_rate, 2,
                                 peak_normalize_output=False, device=dev)
        P = chain.num_params
        counts[i] = P
        accepted: list[np.ndarray] = []
        renders: list[np.ndarray] = []
        tries = 0
        while len(accepted) < num_presets and tries < max_tries:
            tries += 1
            w = rng.random(P).astype(np.float32)
            with torch.no_grad():
                y = render(torch.from_numpy(w).to(dev), x).cpu().numpy()
            if _db(y) < silence_db:
                continue
            if _db(y - x_np) < min_diff_db:
                continue  # inaudible change
            if any(_db(y - r) < min_diff_db for r in renders):
                continue
            accepted.append(w)
            renders.append(y)
        # fall back to unrejected randoms if rejection was too strict
        while len(accepted) < num_presets:
            accepted.append(rng.random(P).astype(np.float32))
        presets[i, :, :P] = np.stack(accepted)

    return PresetBank(instance_names=list(effect_names), presets=presets,
                      param_counts=counts)
