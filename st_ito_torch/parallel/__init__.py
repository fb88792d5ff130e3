"""The device mesh and its collectives — port of ``st_ito_tpu/parallel``.

Two mesh axes by convention, as in the JAX package:
- "pop"  — the CMA-ES population split over the ranks (``ito/engine.py``),
           the fitness values all-gathered;
- "data" — the training batch split over the ranks (``train/``), the
           gradients and metrics all-reduced, BatchNorm over the global
           batch.

A mesh is a ``torch.distributed`` process group (NCCL on the card, gloo on
the CPU); ``launch`` starts its ranks as processes of one host.
"""

from st_ito_torch.parallel.collectives import (all_gather_rows,
                                               all_reduce_max,
                                               all_reduce_mean,
                                               all_reduce_sum,
                                               average_gradients,
                                               batch_max,
                                               gather_rows_to_root,
                                               global_draw, sharded,
                                               shard_rows)
from st_ito_torch.parallel.launch import launch
from st_ito_torch.parallel.mesh import (Mesh, data_sharding, make_mesh,
                                        population_sharding, replicated)

__all__ = ["make_mesh", "population_sharding", "data_sharding", "replicated",
           "Mesh", "launch", "all_gather_rows", "gather_rows_to_root",
           "all_reduce_sum", "all_reduce_mean", "all_reduce_max",
           "average_gradients", "batch_max", "global_draw", "sharded",
           "shard_rows"]
