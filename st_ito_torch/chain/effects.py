"""The basic effects of the ``--effect-type basic`` chain — port of
``st_ito_tpu/chain/effects.py``: the same stage names, parameter names,
ranges, defaults and LTI pads, so flat parameter vectors are interchangeable
with the JAX package. The renderer plans each stage from its ``effect``
(chain/executor.py); the per-candidate ``process_fn`` hooks are ROADMAP §1
item 7."""

from __future__ import annotations

from typing import Mapping

from st_ito_torch.chain.params import ChainSpec, ParamSpec, StageSpec


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
    return StageSpec("ParametricEQ", "parametric_eq", params,
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
    return StageSpec("Compressor", "compressor", params,
                     num_channels=1, fixed_parameters=fixed or {})


def basic_distortion(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """tanh drive + output gain."""
    P = ParamSpec
    params = (
        P("drive_db", -48.0, 48.0, 0.0),
        P("output_gain_db", -24.0, 24.0, 0.0),
    )
    return StageSpec("Distortion", "distortion", params,
                     num_channels=1, fixed_parameters=fixed or {})


def basic_delay(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """Feedback delay."""
    P = ParamSpec
    params = (
        P("delay_seconds", 0.01, 1.0, 0.5),
        P("feedback", 0.05, 1.0, 0.5),
        P("mix", 0.0, 1.0, 0.5),
    )
    return StageSpec("Delay", "delay", params,
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
    return StageSpec("Reverb", "reverb", params,
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
