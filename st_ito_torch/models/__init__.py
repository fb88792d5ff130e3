"""The AFx-Rep Cnn14 encoder, its weight converter and the embedding API."""

from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config
from st_ito_torch.models.convert import cnn14_state_dict_from_jax
from st_ito_torch.models.registry import (
    MFCCFeatureExtractor,
    ParamModel,
    get_mfcc_feature_embeds,
    get_param_embeds,
    get_param_embeds_chunked,
    load_mfcc_feature_extractor,
    load_param_model,
)

__all__ = [
    "Cnn14",
    "Cnn14Config",
    "MFCCFeatureExtractor",
    "ParamModel",
    "cnn14_state_dict_from_jax",
    "get_mfcc_feature_embeds",
    "get_param_embeds",
    "get_param_embeds_chunked",
    "load_mfcc_feature_extractor",
    "load_param_model",
]
