"""Start the ranks of a mesh as processes of this host.

``launch(fn, args, nprocs, backend)`` spawns ``nprocs`` fresh interpreters
(``torch.multiprocessing``, start method "spawn"), each joining one process
group through a file store in a new temporary directory, with ``RANK``,
``LOCAL_RANK`` and ``WORLD_SIZE`` in its environment, and runs
``fn(*args)`` there; ``parallel.make_mesh`` then joins that group. A rank
that raises makes ``launch`` raise (the others are stopped).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, args, nprocs: int, backend: str,
               store_path: str) -> None:
    from st_ito_torch.parallel.mesh import TIMEOUT

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs))
    if backend == "nccl":
        import torch

        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=nprocs,
                            timeout=TIMEOUT)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn, args: tuple, nprocs: int, backend: str) -> None:
    """Run ``fn(*args)`` on ``nprocs`` ranks of a new ``backend`` group
    and wait for all of them. ``fn`` must be importable by name (a module's
    top-level function)."""
    from st_ito_torch.parallel.mesh import check_backend

    check_backend(backend, "cuda" if backend == "nccl" else "cpu", nprocs)
    tmp = tempfile.mkdtemp(prefix="st_ito_mesh_")
    try:
        mp.start_processes(_rank_main,
                           args=(fn, args, nprocs, backend,
                                 os.path.join(tmp, "store")),
                           nprocs=nprocs, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
