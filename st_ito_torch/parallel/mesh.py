"""The device mesh — port of ``st_ito_tpu/parallel/mesh.py``.

A JAX mesh names devices along an axis and XLA's SPMD partitioner computes
the same function over the global arrays. Here a ``Mesh`` is a
``torch.distributed`` process group of one rank per device, with the axis's
name: each rank computes its rows of the leading axis, and the collectives
of ``parallel/collectives.py`` rebuild what one process would have
computed. "pop" splits the ES population (``ito/engine.py``), "data" the
training batch (``train/``).

The backend is NCCL on the card and gloo on the CPU; gloo may be asked for
on the card (several ranks on one card, which NCCL refuses). Nothing
switches backend or device on its own: a card asked for and missing, NCCL
with more ranks than cards, or a ``num_devices`` that is not the group's
world size raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from st_ito_torch.utils import resolve_device

# how long a rank waits for the others at the rendezvous and in a collective
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D mesh: the process group, this rank, the
    world size, the axis name, the backend and this rank's device."""

    group: object
    rank: int
    world_size: int
    axis_name: str
    backend: str
    device: torch.device
    owns_group: bool = False  # make_mesh made the group and closes it

    def close(self) -> None:
        """Destroy the process group where ``make_mesh`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, world_size: int) -> None:
    """Raise where ``backend`` cannot run ``world_size`` ranks on
    ``device``."""
    dev_type = torch.device(device).type
    if backend == "nccl":
        if dev_type != "cuda":
            raise ValueError("the nccl backend runs on the card only; use "
                             "gloo for device='cpu'")
        n = torch.cuda.device_count()
        if world_size > n:
            raise RuntimeError(
                f"nccl needs one card per rank: {world_size} ranks, {n} "
                f"card(s); run several ranks on one card with "
                f"backend='gloo'")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")


def rank_device(device, backend: str, local_rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``local_rank`` (modulo the
    cards there are, under gloo), made the current card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(num_devices: int | None = None, axis_name: str = "pop",
              device="cuda", backend: str | None = None) -> Mesh:
    """A 1-D mesh over the ranks of the default process group: the group
    the caller or ``torchrun`` made (``RANK`` and ``WORLD_SIZE`` in the
    environment, joined through ``env://``), or else a group of world size
    1 made here. ``backend`` defaults to NCCL on the card and gloo on the
    CPU. ``num_devices`` (None: the group's size) must equal the world
    size."""
    resolve_device(device)
    backend = backend or default_backend(device)
    joined = dist.is_initialized()
    torchrun = not joined and "WORLD_SIZE" in os.environ \
        and "RANK" in os.environ
    if joined:
        world, rank = dist.get_world_size(), dist.get_rank()
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not the {backend} asked for")
    elif torchrun:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        world, rank = 1, 0
        if num_devices is not None and num_devices > 1:
            raise RuntimeError(
                f"num_devices={num_devices} needs a process group of "
                f"{num_devices} ranks: start them with torchrun, or with "
                f"parallel.launch, or through a CLI's --num-devices")
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}, but the process group "
                         f"has {world} ranks")
    check_backend(backend, device, world)
    local = int(os.environ.get("LOCAL_RANK", rank))
    if not joined:
        rank_device(device, backend, local)
        if torchrun:
            dist.init_process_group(backend, init_method="env://", rank=rank,
                                    world_size=world, timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
    dev = rank_device(device, backend, local)
    return Mesh(group=dist.group.WORLD, rank=rank, world_size=world,
                axis_name=axis_name, backend=backend, device=dev,
                owns_group=not joined)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leading axis split over the mesh in equal contiguous blocks, rank
    r holding rows [r n / w, (r + 1) n / w) (``P(axis)``); or, with
    ``split`` False, held whole on every rank (``P()``)."""

    mesh: Mesh
    axis_name: str
    split: bool = True

    def rows(self, x):
        """This rank's rows of x."""
        if not self.split:
            return x
        from st_ito_torch.parallel.collectives import shard_rows

        return shard_rows(x, self.mesh)

    def gather(self, x_local):
        """The whole leading axis back on every rank."""
        if not self.split:
            return x_local
        from st_ito_torch.parallel.collectives import all_gather_rows

        return all_gather_rows(x_local, self.mesh)


def population_sharding(mesh: Mesh, axis_name: str = "pop") -> Sharding:
    """Axis 0 (the population) over the mesh; trailing axes whole."""
    return Sharding(mesh, axis_name)


def data_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """Axis 0 (the batch) over the mesh."""
    return Sharding(mesh, axis_name)


def replicated(mesh: Mesh) -> Sharding:
    """Whole on every rank."""
    return Sharding(mesh, mesh.axis_name, split=False)
