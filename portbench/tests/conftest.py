import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# a tiny Cnn14 (hop 128: 32 frames from 3968 samples) and tiny traffic, for
# runs of the whole harness on the CPU
with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "afxrep-cnn14-ito.json")) as f:
    ENCODER = json.load(f)["encoder"]
SMALL_ENCODER = {"config.encoder": {**ENCODER, "base_channels": 2,
                                    "hop_size": 128, "window_size": 512,
                                    "mel_bins": 32, "embed_dim": 8}}
SMALL_ITO = {**SMALL_ENCODER, "config.fitness_dtype": "float32",
             "config.crop_len": 8192, "config.max_iters": 2,
             "traffic.samples": 8192, "traffic.popsize": 4, "traffic.pool": 2}
SMALL_TRAIN = {**SMALL_ENCODER, "config.length": 8192,
               "config.batch_size": 2, "traffic.examples": 8,
               "traffic.shard_examples": 4}


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
