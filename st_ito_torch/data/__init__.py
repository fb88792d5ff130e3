"""Data pipeline: preset banks, dataset synthesis on the card's kernels,
streaming shard datasets with host-side prefetch (the JAX package's
``st_ito_tpu/data``)."""

from st_ito_torch.data.datagen import (generate_pretext_dataset,
                                       generate_style_dataset)
from st_ito_torch.data.datasets import (NpzShardDataset, StyleShardDataset,
                                        prefetch_batches)
from st_ito_torch.data.presets import PresetBank, sample_preset_bank

__all__ = [
    "PresetBank",
    "sample_preset_bank",
    "generate_pretext_dataset",
    "generate_style_dataset",
    "NpzShardDataset",
    "StyleShardDataset",
    "prefetch_batches",
]
