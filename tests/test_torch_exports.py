"""Every name of st_ito_tpu's subpackages' ``__all__`` (``chain``, ``ops``,
``models``, ``ito``, ``eval``) resolves in st_ito_torch's, but for the few
written out in ``NOT_EXPORTED`` with the reason each has."""

import importlib

import pytest

# JAX name -> where the port has it instead, or why it has none
NOT_EXPORTED = {
    "models": {
        # idiom: the Cnn14 is an nn.Module with its init in place
        "cnn14_apply": "Cnn14.forward",
        "init_cnn14_params": "init_cnn14_",
    },
    "ito": {"run_learned_inference": "ROADMAP §1 item 10"},
}


@pytest.mark.parametrize("package", ["chain", "ops", "models", "ito",
                                     "eval"])
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
