"""Effect-chain specs, the effect registry and the two renderers."""

from st_ito_torch.chain.params import ParamSpec, StageSpec, ChainSpec
from st_ito_torch.chain.effects import (
    EFFECT_REGISTRY,
    basic_chain,
    basic_chorus,
    basic_compressor,
    basic_delay,
    basic_distortion,
    basic_gain,
    basic_limiter,
    basic_multiband_compressor,
    basic_noise_gate,
    basic_parametric_eq,
    basic_phaser,
    basic_reverb,
    basic_stereo_widener,
    chain_from_json,
    chain_preset,
)
from st_ito_torch.chain.executor import (
    build_batched_render_fn,
    build_render_fn,
    output_channels,
    parameters_to_dict,
)

__all__ = [
    "ParamSpec",
    "StageSpec",
    "ChainSpec",
    "EFFECT_REGISTRY",
    "basic_chain",
    "basic_chorus",
    "basic_compressor",
    "basic_delay",
    "basic_distortion",
    "basic_gain",
    "basic_limiter",
    "basic_multiband_compressor",
    "basic_noise_gate",
    "basic_parametric_eq",
    "basic_phaser",
    "basic_reverb",
    "basic_stereo_widener",
    "build_batched_render_fn",
    "build_render_fn",
    "chain_from_json",
    "chain_preset",
    "output_channels",
    "parameters_to_dict",
]
