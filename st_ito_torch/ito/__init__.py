"""Inference-time optimisation: the host CMA-ES (``cmaes``), the
device-resident one (``device_es``), ``run_es`` and its staged and
multitrack forms, gradient ITO (``run_autodiff``), and the baselines
(``run_learned_inference``: one forward of a trained StyleTransferSystem)."""

from st_ito_torch.ito.cmaes import CMAES
from st_ito_torch.ito.engine import (
    make_fitness_fn,
    run_autodiff,
    run_es,
    run_es_multitrack,
    run_input,
    run_learned_inference,
    run_random,
    run_rule_based,
    run_staged_es,
)

__all__ = [
    "CMAES",
    "make_fitness_fn",
    "run_es",
    "run_es_multitrack",
    "run_staged_es",
    "run_autodiff",
    "run_input",
    "run_learned_inference",
    "run_random",
    "run_rule_based",
]
