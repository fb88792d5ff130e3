"""Every name of st_ito_tpu's subpackages' ``__all__`` (``chain``, ``ops``,
``models``, ``ito``, ``eval``, ``train``, ``data``) resolves in
st_ito_torch's, but for the few written out in ``NOT_EXPORTED`` with the
reason each has."""

import importlib

import pytest

# JAX name -> where the port has it instead, or why it has none
NOT_EXPORTED = {
    "models": {
        # idiom: the Cnn14 is an nn.Module with its init in place
        "cnn14_apply": "Cnn14.forward",
        "init_cnn14_params": "init_cnn14_",
        # transformers' model behind a handle that the JAX engine scores on
        # the host: the port serves the native tower alone
        "ClapModelHandle": None,
    },
}


@pytest.mark.parametrize("package", ["chain", "ops", "models", "ito",
                                     "eval", "train", "data"])
def test_jax_exports_resolve_in_the_port(package):
    jax_pkg = importlib.import_module(f"st_ito_tpu.{package}")
    pkg = importlib.import_module(f"st_ito_torch.{package}")
    skip = NOT_EXPORTED.get(package, {})
    missing = [name for name in jax_pkg.__all__
               if name not in skip and not hasattr(pkg, name)]
    assert not missing, f"st_ito_torch.{package} lacks {missing}"
    assert set(jax_pkg.__all__) - set(skip) <= set(pkg.__all__)
    assert not set(skip) & set(pkg.__all__)


def test_idiom_counterparts_exist():
    from st_ito_torch.models import Cnn14
    from st_ito_torch.models.cnn14 import init_cnn14_

    assert callable(Cnn14.forward) and callable(init_cnn14_)


# the modules this port added beside the packages' __all__s: every public
# name a JAX module defines resolves in the port's module of that name,
# but for these, with the port's counterpart or the reason it has none
MODULE_COUNTERPARTS = {
    "models.encoders": {
        "init_dstcn_params": "xavier_init_",
        "init_fx_encoder_params": "xavier_init_",
        "dstcn_apply": "DsTCN.forward",
        "fx_encoder_apply": "FXEncoder.forward",
    },
    "models.vggish": {
        "init_vggish_params": "encoders.xavier_init_",
        "vggish_forward": "VGGish.forward",
        # the module loads the upstream state_dict by its own names
        "convert_vggish_state_dict": "VGGish.load_state_dict",
    },
    "models.wav2clip": {
        "init_wav2clip_params": "init_wav2clip_",
        "convert_wav2clip_state_dict": "release_state_dict",
        "_basic_block": "BasicBlock.forward",
        "resnet18_forward": "ResNet18.forward",
        "wav2clip_transform": "Transform.forward",
    },
    "models.beats": {
        "init_beats_params": "init_beats_",
        "convert_beats_state_dict": "BEATs.load_state_dict",
    },
    "models.convert": {
        # nested JAX pytrees only: the port keeps flat state_dicts
        "listify_numeric": None,
        "save_params_npz": "registry.export_encoder_npz",
        "load_params_npz": "registry.load_param_model",
    },
    "models.registry": {"ClapModelHandle": None},
    "models.clap_laion": {
        "init_clap_laion_params": "init_clap_laion_",
        "clap_audio_tower": "ClapAudioTower.forward",
        # the module loads transformers' state_dict by its own names
        "convert_clap_laion_state_dict": "hf_state_dict",
    },
    "models.htsat": {"init_htsat_params": "init_htsat_",
                     "htsat_apply": "HTSAT.forward"},
    "models.clap": {"init_clap_audio_params": "init_clap_audio_",
                    "clap_audio_apply": "CLAPAudio.forward"},
    "models.gcn": {"init_deepgcn_params": "init_deepgcn_",
                   "deepgcn_apply": "DeepGCN.forward"},
    # the heads are modules with their init in place
    "train.style": {"init_regressor": "Regressor",
                    "regressor_apply": "Regressor.forward",
                    "init_classifier": "Classifier",
                    "classifier_apply": "Classifier.forward"},
    "train.param": {}, "data.presets": {}, "data.datagen": {},
    "data.datasets": {}, "data.tar_flac": {}, "data.sim": {},
    "augment": {}, "native.io": {}, "cli.train": {},
    "eval.pst": {}, "eval.pst_examples": {}, "eval.cls": {},
    "eval.listen": {}, "eval.visualize": {}, "eval.metrics": {},
    "cli.eval_pst": {}, "cli.eval_cls": {},
}


@pytest.mark.parametrize("module", sorted(MODULE_COUNTERPARTS))
def test_module_names_resolve_in_the_port(module):
    jax_mod = importlib.import_module(f"st_ito_tpu.{module}")
    mod = importlib.import_module(f"st_ito_torch.{module}")
    skip = MODULE_COUNTERPARTS[module]
    public = [n for n, v in vars(jax_mod).items()
              if not n.startswith("_")
              and getattr(v, "__module__", None) == jax_mod.__name__]
    missing = [n for n in public if n not in skip and not hasattr(mod, n)]
    assert not missing, f"st_ito_torch.{module} lacks {missing}"
    assert not [n for n in skip if hasattr(mod, n)]
    for counterpart in skip.values():
        if counterpart and "." not in counterpart and "§" not in counterpart:
            assert hasattr(mod, counterpart), counterpart
