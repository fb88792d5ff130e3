"""Effect-chain specs, the basic effects and the two renderers."""

from st_ito_torch.chain.params import ParamSpec, StageSpec, ChainSpec
from st_ito_torch.chain.effects import (
    basic_chain,
    basic_compressor,
    basic_delay,
    basic_distortion,
    basic_parametric_eq,
    basic_reverb,
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
    "basic_chain",
    "basic_compressor",
    "basic_delay",
    "basic_distortion",
    "basic_parametric_eq",
    "basic_reverb",
    "build_batched_render_fn",
    "build_render_fn",
    "output_channels",
    "parameters_to_dict",
]
