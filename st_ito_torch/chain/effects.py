"""The basic effects of the ``--effect-type basic`` chain — port of
``st_ito_tpu/chain/effects.py``: the same stage names, parameter names,
ranges, defaults and LTI pads, so flat parameter vectors are interchangeable
with the JAX package. The population renderer plans each stage from its
``effect`` (chain/executor.py ``build_batched_render_fn``); the
per-candidate renderer (``build_render_fn``) calls each stage's
``process_fn(x (C, T), params, sample_rate)``, plain PyTorch ops on x's
device."""

from __future__ import annotations

from typing import Mapping

import torch

from st_ito_torch.chain.params import ChainSpec, ParamSpec, StageSpec
from st_ito_torch.ops import delay as _delay
from st_ito_torch.ops import dynamics as _dyn
from st_ito_torch.ops import eq as _eq
from st_ito_torch.ops import reverb as _rev
from st_ito_torch.ops import waveshape as _ws


def basic_parametric_eq(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """18-param 6-section EQ."""
    P = ParamSpec
    params = (
        P("low_shelf_gain_db", -24.0, 24.0, 0.0),
        P("low_shelf_cutoff_freq", 20.0, 4000.0, 80.0),
        P("low_shelf_q_factor", 0.1, 4.0, 0.707),
        P("band0_gain_db", -24.0, 24.0, 0.0),
        P("band0_cutoff_freq", 20.0, 10000.0, 300.0),
        P("band0_q_factor", 0.1, 4.0, 0.707),
        P("band1_gain_db", -24.0, 24.0, 0.0),
        P("band1_cutoff_freq", 20.0, 10000.0, 1000.0),
        P("band1_q_factor", 0.1, 4.0, 0.707),
        P("band2_gain_db", -24.0, 24.0, 0.0),
        P("band2_cutoff_freq", 20.0, 10000.0, 3000.0),
        P("band2_q_factor", 0.1, 4.0, 0.707),
        P("band3_gain_db", -24.0, 24.0, 0.0),
        P("band3_cutoff_freq", 20.0, 10000.0, 10000.0),
        P("band3_q_factor", 0.1, 4.0, 0.707),
        P("high_shelf_gain_db", -24.0, 24.0, 0.0),
        P("high_shelf_cutoff_freq", 200.0, 18000.0, 1000.0),
        P("high_shelf_q_factor", 0.1, 4.0, 0.707),
    )

    def process(x, p, sr):
        def bands(key):
            return torch.stack([torch.as_tensor(p[f"band{i}_{key}"])
                                for i in range(4)], dim=-1)

        return _eq.parametric_eq(
            x, sr,
            low_shelf_gain_db=p["low_shelf_gain_db"],
            low_shelf_cutoff_freq=p["low_shelf_cutoff_freq"],
            low_shelf_q_factor=p["low_shelf_q_factor"],
            band_gains_db=bands("gain_db"),
            band_cutoff_freqs=bands("cutoff_freq"),
            band_q_factors=bands("q_factor"),
            high_shelf_gain_db=p["high_shelf_gain_db"],
            high_shelf_cutoff_freq=p["high_shelf_cutoff_freq"],
            high_shelf_q_factor=p["high_shelf_q_factor"],
        )

    return StageSpec("ParametricEQ", "parametric_eq", params, process,
                     num_channels=1, fixed_parameters=fixed or {}, pad=8192)


def basic_compressor(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """4-param compressor (soft knee 0.5 dB, no makeup, unlinked)."""
    P = ParamSpec
    params = (
        P("threshold_db", -80.0, 0.0, 0.0),
        P("ratio", 1.0, 20.0, 4.0),
        P("attack_ms", 0.1, 100.0, 1.0),
        P("release_ms", 10.0, 1000.0, 100.0),
    )

    def process(x, p, sr):
        return _dyn.compressor(
            x, sr, threshold_db=p["threshold_db"], ratio=p["ratio"],
            attack_ms=p["attack_ms"], release_ms=p["release_ms"],
            knee_db=0.5, makeup_gain_db=0.0, link_channels=False)

    return StageSpec("Compressor", "compressor", params, process,
                     num_channels=1, fixed_parameters=fixed or {})


def basic_distortion(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """tanh drive + output gain."""
    P = ParamSpec
    params = (
        P("drive_db", -48.0, 48.0, 0.0),
        P("output_gain_db", -24.0, 24.0, 0.0),
    )

    def process(x, p, sr):
        return _ws.gain(_ws.distortion(x, p["drive_db"]), p["output_gain_db"])

    return StageSpec("Distortion", "distortion", params, process,
                     num_channels=1, fixed_parameters=fixed or {})


def basic_delay(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """Feedback delay."""
    P = ParamSpec
    params = (
        P("delay_seconds", 0.01, 1.0, 0.5),
        P("feedback", 0.05, 1.0, 0.5),
        P("mix", 0.0, 1.0, 0.5),
    )

    def process(x, p, sr):
        return _delay.feedback_delay(x, sr, p["delay_seconds"], p["feedback"],
                                     p["mix"])

    return StageSpec("Delay", "delay", params, process,
                     num_channels=2, fixed_parameters=fixed or {}, pad=-1)


def basic_reverb(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """Freeverb with wet/dry crossfade."""
    P = ParamSpec
    params = (
        P("room_size", 0.0, 1.0, 0.5),
        P("damping", 0.0, 1.0, 0.5),
        P("wet_dry", 0.0, 1.0, 0.5),
        P("width", 0.0, 1.0, 0.5),
    )

    def process(x, p, sr):
        return _rev.freeverb(
            x, sr, room_size=p["room_size"], damping=p["damping"],
            wet_level=p["wet_dry"], dry_level=1.0 - p["wet_dry"],
            width=p["width"])

    return StageSpec("Reverb", "reverb", params, process,
                     num_channels=2, fixed_parameters=fixed or {}, pad=-1)


def basic_chain(with_bypass: bool = True) -> ChainSpec:
    """The reference CLI's --effect-type basic chain:
    EQ -> Compressor -> Distortion -> Delay -> Reverb (36 raw params)."""
    return ChainSpec(
        stages=(
            basic_parametric_eq(),
            basic_compressor(),
            basic_distortion(),
            basic_delay(),
            basic_reverb(),
        ),
        with_bypass=with_bypass,
    )
