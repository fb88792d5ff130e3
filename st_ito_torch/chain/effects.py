"""The effect registry — port of ``st_ito_tpu/chain/effects.py``: the same
stage names, parameter names, ranges, defaults and LTI pads, so flat
parameter vectors are interchangeable with the JAX package, and the same
``EFFECT_REGISTRY``, ``chain_from_json`` and ``chain_preset``. The
population renderer plans each stage from its ``effect``
(chain/executor.py ``build_batched_render_fn``); the per-candidate renderer
(``build_render_fn``) calls each stage's ``process_fn(x (C, T), params,
sample_rate)``, plain PyTorch ops on x's device; every LTI stage (EQ,
delay, reverb, gain, widener) carries its ``response_fn``
(chain/responses.py), the per-stage response path of the population
renderer."""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping

import torch

from st_ito_torch.chain import responses as _resp
from st_ito_torch.chain.params import ChainSpec, ParamSpec, StageSpec
from st_ito_torch.ops import delay as _delay
from st_ito_torch.ops import dynamics as _dyn
from st_ito_torch.ops import eq as _eq
from st_ito_torch.ops import reverb as _rev
from st_ito_torch.ops import stereo as _st
from st_ito_torch.ops import waveshape as _ws
from st_ito_torch.ops.multiband import multiband_compressor


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
                     num_channels=1, fixed_parameters=fixed or {}, pad=8192,
                     response_fn=_resp.eq_response)


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
                     num_channels=2, fixed_parameters=fixed or {}, pad=-1,
                     response_fn=_resp.delay_response)


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
                     num_channels=2, fixed_parameters=fixed or {}, pad=-1,
                     response_fn=_resp.freeverb_response)


def basic_chorus(fixed: Mapping[str, float] | None = None) -> StageSpec:
    """LFO-modulated fractional delay; unlike the reference, rate_hz is
    honoured."""
    P = ParamSpec
    params = (
        P("rate_hz", 0.1, 10.0, 1.0),
        P("centre_delay_ms", 0.1, 20.0, 7.0),
        P("depth", 0.0, 1.0, 0.1),
        P("feedback", 0.0, 1.0, 0.5),
        P("mix", 0.0, 1.0, 0.5),
    )

    def process(x, p, sr):
        return _delay.chorus(x, sr, p["rate_hz"], p["centre_delay_ms"],
                             p["depth"], p["feedback"], p["mix"])

    return StageSpec("Chorus", "chorus", params, process,
                     num_channels=2, fixed_parameters=fixed or {})


def basic_limiter(fixed: Mapping[str, float] | None = None) -> StageSpec:
    P = ParamSpec
    params = (
        P("threshold_db", -40.0, 0.0, -6.0),
        P("release_ms", 10.0, 1000.0, 100.0),
    )

    def process(x, p, sr):
        return _dyn.limiter(x, sr, threshold_db=p["threshold_db"],
                            release_ms=p["release_ms"])

    return StageSpec("Limiter", "limiter", params, process,
                     num_channels=2, fixed_parameters=fixed or {})


def basic_noise_gate(fixed: Mapping[str, float] | None = None) -> StageSpec:
    P = ParamSpec
    params = (
        P("threshold_db", -100.0, 0.0, -60.0),
        P("ratio", 1.0, 10.0, 10.0),
        P("attack_ms", 0.1, 100.0, 1.0),
        P("release_ms", 10.0, 1000.0, 100.0),
    )

    def process(x, p, sr):
        return _dyn.noise_gate(x, sr, p["threshold_db"], p["ratio"],
                               p["attack_ms"], p["release_ms"])

    return StageSpec("NoiseGate", "noise_gate", params, process,
                     num_channels=2, fixed_parameters=fixed or {})


def basic_gain(fixed: Mapping[str, float] | None = None) -> StageSpec:
    params = (ParamSpec("gain_db", -24.0, 24.0, 0.0),)

    def process(x, p, sr):
        return _ws.gain(x, p["gain_db"])

    return StageSpec("Gain", "gain", params, process,
                     num_channels=1, fixed_parameters=fixed or {}, pad=0,
                     response_fn=_resp.gain_response)


def basic_stereo_widener(fixed: Mapping[str, float] | None = None
                         ) -> StageSpec:
    params = (ParamSpec("width", 0.0, 1.0, 0.5),)

    def process(x, p, sr):
        return _st.stereo_widener(x, p["width"])

    return StageSpec("StereoWidener", "stereo_widener", params, process,
                     num_channels=2, fixed_parameters=fixed or {}, pad=0,
                     response_fn=_resp.widener_response)


def basic_phaser(fixed: Mapping[str, float] | None = None) -> StageSpec:
    P = ParamSpec
    params = (
        P("rate_hz", 0.1, 10.0, 1.0),
        P("depth", 0.0, 1.0, 0.5),
        P("centre_frequency_hz", 100.0, 8000.0, 1300.0),
        P("feedback", 0.0, 1.0, 0.0),
        P("mix", 0.0, 1.0, 0.5),
    )

    def process(x, p, sr):
        return _delay.phaser(x, sr, p["rate_hz"], p["depth"],
                             p["centre_frequency_hz"], p["feedback"],
                             p["mix"])

    return StageSpec("Phaser", "phaser", params, process,
                     num_channels=2, fixed_parameters=fixed or {})


def basic_multiband_compressor(fixed: Mapping[str, float] | None = None
                               ) -> StageSpec:
    """3-band compressor with LR4 crossovers (the reference style chain's
    ZaMultiCompX2 role)."""
    P = ParamSpec
    params = (
        P("xover_low_hz", 40.0, 1000.0, 250.0),
        P("xover_high_hz", 1000.0, 12000.0, 4000.0),
        P("low_threshold_db", -60.0, 0.0, -24.0),
        P("low_ratio", 1.0, 20.0, 4.0),
        P("low_makeup_db", -12.0, 12.0, 0.0),
        P("mid_threshold_db", -60.0, 0.0, -24.0),
        P("mid_ratio", 1.0, 20.0, 4.0),
        P("mid_makeup_db", -12.0, 12.0, 0.0),
        P("high_threshold_db", -60.0, 0.0, -24.0),
        P("high_ratio", 1.0, 20.0, 4.0),
        P("high_makeup_db", -12.0, 12.0, 0.0),
        P("attack_ms", 0.1, 100.0, 10.0),
        P("release_ms", 10.0, 1000.0, 150.0),
    )

    def process(x, p, sr):
        return multiband_compressor(
            x, sr, xover_low=p["xover_low_hz"], xover_high=p["xover_high_hz"],
            thresholds_db=(p["low_threshold_db"], p["mid_threshold_db"],
                           p["high_threshold_db"]),
            ratios=(p["low_ratio"], p["mid_ratio"], p["high_ratio"]),
            makeup_db=(p["low_makeup_db"], p["mid_makeup_db"],
                       p["high_makeup_db"]),
            attack_ms=p["attack_ms"], release_ms=p["release_ms"])

    return StageSpec("MultibandCompressor", "multiband_compressor", params,
                     process, num_channels=2, fixed_parameters=fixed or {})


EFFECT_REGISTRY = {
    "parametric_eq": basic_parametric_eq,
    "compressor": basic_compressor,
    "distortion": basic_distortion,
    "delay": basic_delay,
    "reverb": basic_reverb,
    "chorus": basic_chorus,
    "limiter": basic_limiter,
    "noise_gate": basic_noise_gate,
    "gain": basic_gain,
    "stereo_widener": basic_stereo_widener,
    "phaser": basic_phaser,
    "multiband_compressor": basic_multiband_compressor,
}

# VST and reference class names -> the native effect each stands for
VST_EFFECTS = {
    "BasicParametricEQ": "parametric_eq", "BasicCompressor": "compressor",
    "BasicDistortion": "distortion", "BasicDelay": "delay",
    "BasicReverb": "reverb", "BasicChorus": "chorus",
    "ZamEQ2": "parametric_eq", "ZamDelay": "delay",
    "FlyingDelay": "delay", "TAL-Reverb-4": "reverb",
    "DragonflyPlateReverb": "reverb", "ZaMultiCompX2": "multiband_compressor",
    "ZamCompX2": "compressor", "ZaMaximX2": "limiter",
    "TubeScreamer": "distortion", "STR-X": "distortion",
    "RoughRider3": "compressor",
}


def chain_from_json(path: str, with_bypass: bool = True) -> ChainSpec:
    """Declarative chain from a JSON spec in the reference's vst-chains
    format: {stage_name: {"effect"|"class_path"|"vst_filepath": ...,
    "num_channels": ..., "fixed_parameters": {...}}}. VST class names map
    to their native equivalents (``VST_EFFECTS``).

    Fixed-parameter units: an entry may declare ``"units": "raw"`` or
    ``"units": "physical"``; without it, values inside [0, 1] are taken as
    raw and values outside are converted from physical units with the
    parameter's range (a physical value that falls in [0, 1], e.g.
    ``ratio: 1.0``, therefore needs an explicit ``units``)."""
    with open(path) as f:
        spec = json.load(f)
    stages = []
    for name, entry in spec.items():
        effect = entry.get("effect")
        if effect is None:
            cp = entry.get("class_path", entry.get("vst_filepath", ""))
            base = cp.rsplit("/", 1)[-1].replace(".vst3", "").rsplit(".", 1)[-1]
            effect = VST_EFFECTS.get(base)
        if effect is None or effect not in EFFECT_REGISTRY:
            raise ValueError(f"cannot map chain stage {name!r} ({entry}) to a "
                             f"native effect")
        fixed = entry.get("fixed_parameters")
        if fixed:
            specs = {p.name: p for p in EFFECT_REGISTRY[effect]().params}
            units = entry.get("units")
            converted = {}
            for pname, value in fixed.items():
                if pname not in specs:
                    raise ValueError(
                        f"stage {name!r}: unknown fixed parameter {pname!r}; "
                        f"available: {sorted(specs)}")
                pspec = specs[pname]
                physical = (units == "physical" if units is not None
                            else not (0.0 <= value <= 1.0))
                raw = float(pspec.normalize(value)) if physical else float(value)
                if not (0.0 <= raw <= 1.0):
                    raise ValueError(
                        f"stage {name!r}: fixed {pname}={value} maps to raw "
                        f"{raw:.3f} outside [0,1] (range "
                        f"[{pspec.min_value}, {pspec.max_value}])")
                converted[pname] = raw
            fixed = converted
        stage = EFFECT_REGISTRY[effect](fixed=fixed)
        stages.append(dataclasses.replace(
            stage, name=name,
            num_channels=entry.get("num_channels", stage.num_channels)))
    return ChainSpec(stages=tuple(stages), with_bypass=with_bypass)


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


def chain_preset(name: str, with_bypass: bool = True) -> ChainSpec:
    """Named chains mirroring the PST benchmark's chain types.

    general:   distortion -> EQ -> compressor -> delay -> reverb
    simple:    EQ -> compressor
    speech:    EQ -> compressor -> distortion -> reverb
    mastering: EQ -> compressor -> limiter
    vocals:    EQ -> compressor -> delay -> reverb
    guitar:    distortion -> EQ -> reverb
    """
    presets = {
        "general": (basic_distortion, basic_parametric_eq, basic_compressor,
                    basic_delay, basic_reverb),
        "simple": (basic_parametric_eq, basic_compressor),
        "speech": (basic_parametric_eq, basic_compressor, basic_distortion,
                   basic_reverb),
        "mastering": (basic_parametric_eq, basic_compressor, basic_limiter),
        "vocals": (basic_parametric_eq, basic_compressor, basic_delay,
                   basic_reverb),
        "guitar": (basic_distortion, basic_parametric_eq, basic_reverb),
    }
    if name not in presets:
        raise ValueError(f"unknown chain preset: {name} "
                         f"(have {sorted(presets)})")
    return ChainSpec(stages=tuple(build() for build in presets[name]),
                     with_bypass=with_bypass)
