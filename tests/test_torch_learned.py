"""``run_learned_inference`` against st_ito_tpu's with the JAX weights of
a StyleTransferSystem carried in (mono input and target duplicated to
stereo), and the PST benchmark's learned baselines through
``default_methods(style_systems=...)``."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_train_style import T, audio, systems  # noqa: E402

from st_ito_tpu.ito import run_learned_inference as jax_learned

from st_ito_torch.chain import chain_preset
from st_ito_torch.eval import pst
from st_ito_torch.ito import run_learned_inference
from st_ito_torch.models import get_mfcc_feature_embeds
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

torch.set_num_threads(1)


def test_run_learned_inference_matches_jax():
    """The predicted parameters within 1e-5, the render within 1e-4 x
    peak."""
    js, ts, jstate, state = systems(loss_type="audio")
    x, y = audio((1, 1, T), 1), audio((1, 2, T), 2)
    got = run_learned_inference(x, y, 48000, ts, state)
    want = jax_learned(jnp.asarray(x), jnp.asarray(y), 48000, js, jstate)
    assert set(got["params"]) == set(want["params"])
    assert max(abs(got["params"][k] - want["params"][k])
               for k in want["params"]) <= 1e-5
    w = np.asarray(want["output_audio"])
    g = got["output_audio"].numpy()
    assert g.shape == w.shape == (1, 2, T)
    assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_default_methods_runs_the_learned_baselines():
    _, ts, _, state = systems(loss_type="parameter-regression")
    methods = pst.default_methods(
        chain_preset("guitar"), None, get_mfcc_feature_embeds,
        style_systems={"deepafx-st": (ts, state), "deepafx-st+": (ts, state)},
        device="cpu")
    assert list(methods) == ["input", "random", "rule-based", "deepafx-st",
                             "deepafx-st+", "style-es"]
    x = torch.from_numpy(audio((1, 2, T), 3))
    for name in ("deepafx-st", "deepafx-st+"):
        out = methods[name]["func"](x, x, 48000)
        assert torch.isfinite(out["output_audio"]).all()
        assert len(out["params"]) == ts.num_params
