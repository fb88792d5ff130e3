"""The device-resident CMA-ES and the ITO loop ``run_es``."""

from st_ito_torch.ito.engine import make_fitness_fn, run_es

__all__ = ["make_fitness_fn", "run_es"]
