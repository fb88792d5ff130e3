"""Trained states carried across: the JAX ParamEstimator's params of each
non-Cnn14 encoder_type into the port's ``ParamEstimator`` (strictly) and
back into the JAX pytree (``models/convert.py``); the Cnn14's round trip
is in ``test_torch_train_param``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_train_adv import _encoder_configs  # noqa: E402
from test_torch_train_param import configs  # noqa: E402

from st_ito_torch.train import param as tparam

torch.set_num_threads(1)


@pytest.mark.parametrize("encoder_type", ["dstcn", "gcn", "htsat", "clap",
                                          "clap-laion"])
def test_trained_state_round_trip_every_encoder(encoder_type):
    """The JAX estimator's params -> the port's state_dict (loaded
    strictly) -> the JAX pytree again, equal leaf for leaf. The JAX
    trainer builds its LAION-CLAP tower at the published config whatever
    ``cfg.encoder`` says (the port builds it at ``cfg.encoder``; the yaml
    gives the published one), so that tower's pytree comes from
    ``init_clap_laion_params`` at the small config."""
    import jax

    from st_ito_tpu.models import clap as jclap
    from st_ito_tpu.models import clap_laion as jlaion
    from st_ito_tpu.models import gcn as jgcn
    from st_ito_tpu.models import htsat as jhtsat
    from st_ito_tpu.models.encoders import DsTCNConfig as JDs
    from st_ito_tpu.train import param as jparam

    from st_ito_torch.models.convert import (
        flatten_params, param_estimator_params_to_jax,
        param_estimator_state_dict_from_jax)

    tower = dict(dim=16, depths=(1, 1, 1, 1), heads=(2, 2, 4, 4),
                 num_frames=64)
    laion = dict(spec_size=64, n_mels=16, patch=4, window=4,
                 depths=(1, 2, 1), heads=(2, 4, 8), patch_dim=16, hidden=64,
                 proj_dim=16)
    jenc = {"dstcn": JDs(embed_dim=16, ninputs=2, nblocks=3, channel_width=4),
            "gcn": jgcn.DeepGCNConfig(embed_dim=16, model_size="t",
                                      num_frames=64),
            "htsat": jhtsat.HTSATConfig(embed_dim=16, **tower),
            "clap": jclap.CLAPAudioConfig(
                embed_dim=16, tower=jhtsat.HTSATConfig(embed_dim=24, **tower)),
            "clap-laion": jhtsat.HTSATConfig(embed_dim=16, **tower),
            }[encoder_type]
    tenc = _encoder_configs().get(encoder_type) or configs(
        "concat", None, "dstcn")[1].encoder
    kw = dict(num_instances=5, num_presets=3, num_adv_classes=2)
    jcfg = jparam.ParamEstimatorConfig(
        encoder=jenc, encoder_type=("htsat" if encoder_type == "clap-laion"
                                    else encoder_type), **kw)
    params = jax.jit(jparam.init_param_estimator, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg).params
    if encoder_type == "clap-laion":
        params = dict(params, encoder=jax.jit(
            jlaion.init_clap_laion_params, static_argnums=1)(
                jax.random.PRNGKey(1), jlaion.ClapLaionConfig(**laion)))
    tcfg = tparam.ParamEstimatorConfig(encoder=tenc,
                                       encoder_type=encoder_type, **kw)
    model = tparam.ParamEstimator(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(param_estimator_state_dict_from_jax(
        params, encoder_type))
    back = flatten_params(param_estimator_params_to_jax(
        model.state_dict(), encoder_type))
    want = flatten_params(params)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], np.asarray(want[k])) for k in want)
