"""The port's Cnn14 and get_param_embeds against st_ito_tpu's, with the JAX
weights carried across by cnn14_state_dict_from_jax, and the npz layout
that st_ito_tpu's export_encoder_npz writes."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.cnn14 import cnn14_apply, init_cnn14_params
from st_ito_tpu.models.registry import ParamModel as JaxParamModel
from st_ito_tpu.models.registry import export_encoder_npz
from st_ito_tpu.models.registry import get_param_embeds as jax_embeds

from st_ito_torch.models import (Cnn14, Cnn14Config, ParamModel,
                                 cnn14_state_dict_from_jax, get_param_embeds,
                                 load_param_model)
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401
from tests.torch_train_draws import reference_jit

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SMALL = dict(embed_dim=32, window_size=512, hop_size=256, mel_bins=32,
             base_channels=4)
T = 8192
jax_apply = jax.jit(cnn14_apply, static_argnames=("config",))
# jitted with LLVM's optimisation off (``reference_jit``): weights both
# packages take as they are, in a fraction of the eager init's time
jax_init = reference_jit(init_cnn14_params, static_argnums=1)


def jax_params(seed=0, random_bn=True):
    """Small JAX Cnn14 weights, with non-trivial BatchNorm statistics when
    random_bn. The shifts stay near the deep activations' ~1e-5 scale:
    larger ones swamp them and every input embeds alike."""
    params = jax_init(jax.random.PRNGKey(seed), JaxCnn14Config(**SMALL))
    if not random_bn:
        return params
    rng = np.random.default_rng(seed)
    for name, block in params.items():
        for bn in ([block] if name == "bn0" else
                   [v for k, v in block.items() if k.startswith("bn")]):
            c = bn["weight"].shape[0]
            bn["running_mean"] = jnp.asarray(rng.uniform(-1e-6, 1e-6, c),
                                             jnp.float32)
            bn["running_var"] = jnp.asarray(rng.uniform(0.5, 2.0, c),
                                            jnp.float32)
            bn["weight"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
            bn["bias"] = jnp.asarray(rng.uniform(-1e-6, 1e-6, c), jnp.float32)
    return params


def port_model(params):
    net = Cnn14(Cnn14Config(**SMALL))
    net.load_state_dict(cnn14_state_dict_from_jax(params))
    return ParamModel(net=net, config=net.config, embed_dim=SMALL["embed_dim"])


def _l2(e):
    e = np.asarray(e, np.float64)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def assert_embeds_close(got, want):
    """Cosine > 1 - 1e-5 and max |diff| <= 1e-4 on L2-normalised
    embeddings."""
    g, w = _l2(got), _l2(want)
    cos = np.sum(g * w, axis=-1)
    assert np.all(cos > 1 - 1e-5), cos
    assert np.abs(g - w).max() <= 1e-4, np.abs(g - w).max()


@pytest.mark.parametrize("chs", [2, 1])
def test_cnn14_matches_jax(chs):
    params = jax_params()
    x = np.random.default_rng(chs).standard_normal((3, chs, T)).astype(
        np.float32) * 0.5
    mid_j, side_j = jax_apply(params, jnp.asarray(x),
                              JaxCnn14Config(**SMALL))
    mid_t, side_t = port_model(params)(torch.from_numpy(x))
    assert mid_t.shape == (3, SMALL["embed_dim"])
    assert_embeds_close(mid_t.numpy(), mid_j)
    assert_embeds_close(side_t.numpy(), side_j)
    if chs == 1:
        np.testing.assert_array_equal(mid_t.numpy(), side_t.numpy())


def test_get_param_embeds_matches_jax():
    params = jax_params(1)
    x = np.random.default_rng(4).standard_normal((2, 2, T)).astype(
        np.float32) * 0.1
    want = jax_embeds(jnp.asarray(x), JaxParamModel(
        params=params, config=JaxCnn14Config(**SMALL), embed_dim=32), 48000)
    got = get_param_embeds(torch.from_numpy(x), port_model(params), 48000)
    assert got.keys() == want.keys() == {"mid", "side"}
    for k in want:
        np.testing.assert_allclose(np.linalg.norm(got[k].numpy(), axis=-1),
                                   1.0, atol=1e-5)
        assert_embeds_close(got[k].numpy(), want[k])


def test_bfloat16_conv_stack_runs_close_to_float32():
    model = port_model(jax_params())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 2, T)).astype(np.float32))
    e32 = get_param_embeds(x, model, 48000)
    e16 = get_param_embeds(x, dataclasses.replace(model, config=dataclasses
                           .replace(model.config, compute_dtype="bfloat16")),
                           48000)
    for k in e32:
        assert e16[k].dtype == torch.float32
        cos = (e32[k] * e16[k]).sum(-1)
        assert torch.all(cos > 0.99), cos


def test_npz_roundtrip_through_export_layout(tmp_path):
    params = jax_params(2)
    path = str(tmp_path / "enc.npz")
    export_encoder_npz(params, path, JaxCnn14Config(**SMALL))
    model = load_param_model(path, device="cpu")
    assert model.config == Cnn14Config(**SMALL)
    x = np.random.default_rng(6).standard_normal((1, 2, T)).astype(np.float32)
    mid_j, _ = jax_apply(params, jnp.asarray(x), JaxCnn14Config(**SMALL))
    mid_t, _ = model(torch.from_numpy(x))
    assert_embeds_close(mid_t.numpy(), mid_j)


def test_random_model_is_seeded_and_deployed_width():
    a = load_param_model(allow_random=True, seed=3, device="cpu")
    b = load_param_model(allow_random=True, seed=3, device="cpu")
    assert a.config == Cnn14Config() and a.embed_dim == 512
    assert a.net.conv_block6.conv2.weight.shape == (2048, 2048, 3, 3)
    for (k, va), vb in zip(a.net.state_dict().items(),
                           b.net.state_dict().values()):
        assert torch.equal(va, vb), k


def test_too_short_input_raises():
    with pytest.raises(ValueError, match="32 frames"):
        port_model(jax_params())(torch.zeros(1, 2, 4096))
