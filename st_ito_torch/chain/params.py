"""Chain/stage/parameter specs and the flat-vector codec (port of
``st_ito_tpu/chain/params.py``).

The flat raw [0, 1] vector has the same layout as the JAX package's: a
leading ``our_bypass`` slot per stage when ``with_bypass`` (w > 0.5 skips the
stage), then the stage's parameters in declaration order, fixed parameters
still occupying their slot.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One normalized parameter with its physical range."""

    name: str
    min_value: float
    max_value: float
    default: float  # physical units

    @property
    def default_raw(self) -> float:
        return (self.default - self.min_value) / (self.max_value - self.min_value)

    def denormalize(self, raw):
        return raw * (self.max_value - self.min_value) + self.min_value

    def normalize(self, value):
        return (value - self.min_value) / (self.max_value - self.min_value)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One effect in the chain.

    ``effect`` names the effect; the population renderer plans its kernels
    from it (chain/executor.py). ``pad``: guard samples for the stage's
    impulse-response tail when fused into an LTI group (-1 = one full signal
    length, for feedback tails). ``process_fn(x (C, T), params, sample_rate)
    -> y`` is the per-candidate render hook (``build_render_fn``), params a
    dict name -> denormalized 0-d tensor. ``response_fn(params, omega,
    sample_rate, channels) -> (kind, H)``: the LTI stage's frequency
    response batched over the population (chain/responses.py); an LTI
    stage has one, and the population renderer groups such stages."""

    name: str
    effect: str
    params: tuple[ParamSpec, ...]
    process_fn: Callable | None = None
    num_channels: int = 2
    fixed_parameters: Mapping[str, float] = dataclasses.field(default_factory=dict)
    pad: int = 8192
    response_fn: Callable | None = None

    @property
    def param_names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.params)


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """A serial chain. with_bypass adds the reference's leading 'our_bypass'
    slot per stage (w > 0.5 skips the stage)."""

    stages: tuple[StageSpec, ...]
    with_bypass: bool = True

    @property
    def num_params(self) -> int:
        n = 0
        for s in self.stages:
            n += len(s.params) + (1 if self.with_bypass else 0)
        return n

    def init_params(self) -> torch.Tensor:
        """Flat raw vector of stage defaults (bypass slots = 0: active)."""
        vals = []
        for s in self.stages:
            if self.with_bypass:
                vals.append(0.0)
            for p in s.params:
                if p.name in s.fixed_parameters:
                    vals.append(float(s.fixed_parameters[p.name]))
                else:
                    vals.append(p.default_raw)
        return torch.tensor(vals, dtype=torch.float32)

    def stage_slices(self) -> list[tuple[StageSpec, int, int]]:
        """(stage, start, end) index ranges into the flat vector."""
        out = []
        idx = 0
        for s in self.stages:
            width = len(s.params) + (1 if self.with_bypass else 0)
            out.append((s, idx, idx + width))
            idx += width
        return out
