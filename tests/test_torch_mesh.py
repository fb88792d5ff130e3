"""``st_ito_torch.parallel`` in this process: ``make_mesh`` of world size 1
on the CPU and the shardings over it, and the refusals (a group that is
not there, a ``num_devices`` that is not the group's size, NCCL with more
ranks than cards, ``launch`` before it starts a rank). The runs of 2 ranks
are in ``test_torch_mesh_es.py``, ``test_torch_mesh_train.py`` and
``test_torch_mesh_cli.py``."""

import pytest
import torch
import torch.distributed as dist

from st_ito_torch import parallel
from st_ito_torch.parallel import mesh as pmesh

torch.set_num_threads(1)


def test_world_size_1_mesh_on_the_cpu():
    """A group of one made here (gloo on the CPU), the shardings the
    identity over it, every collective too; closing destroys the group
    make_mesh made."""
    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device="cpu", axis_name="data")
    try:
        assert (mesh.rank, mesh.world_size, mesh.backend, mesh.axis_name,
                mesh.device.type) == (0, 1, "gloo", "data", "cpu")
        x = torch.arange(12.0).reshape(6, 2)
        for sharding in (parallel.population_sharding(mesh),
                         parallel.data_sharding(mesh),
                         parallel.replicated(mesh)):
            assert torch.equal(sharding.rows(x), x)
            assert torch.equal(sharding.gather(x), x)
        assert parallel.all_reduce_mean(x, mesh) is x
        with parallel.sharded(mesh):
            g = torch.Generator().manual_seed(0)
            a = parallel.global_draw(
                lambda s: torch.rand(s, generator=g), (3, 2))
        assert torch.equal(a, torch.rand((3, 2), generator=torch.Generator()
                                         .manual_seed(0)))
        # joining the group that exists, with its size
        assert parallel.make_mesh(1, device="cpu").owns_group is False
    finally:
        mesh.close()
    assert not dist.is_initialized()


def test_a_mesh_of_more_ranks_needs_their_group(monkeypatch):
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        parallel.make_mesh(2, device="cpu")
    # under torchrun, a num_devices that is not WORLD_SIZE raises before
    # joining (no rank would come)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="num_devices=4, but the process "
                                         "group has 2 ranks"):
        parallel.make_mesh(4, device="cpu")
    assert not dist.is_initialized()


@pytest.fixture
def one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_nccl_needs_a_card_per_rank(one_card, monkeypatch):
    with pytest.raises(RuntimeError, match="2 ranks, 1 card"):
        pmesh.check_backend("nccl", "cuda", 2)
    pmesh.check_backend("gloo", "cuda", 2)  # gloo shares the card
    with pytest.raises(ValueError, match="card only"):
        pmesh.check_backend("nccl", "cpu", 1)
    with pytest.raises(RuntimeError, match="2 ranks, 1 card"):
        parallel.launch(print, (), 2, "nccl")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="2 ranks, 1 card"):
        parallel.make_mesh(2, device="cuda")
    assert not dist.is_initialized()


def test_shard_rows_takes_equal_blocks_and_refuses_the_rest():
    x = torch.arange(8)
    mesh = pmesh.Mesh(group=None, rank=1, world_size=4, axis_name="pop",
                      backend="gloo", device=torch.device("cpu"))
    assert parallel.shard_rows(x, mesh).tolist() == [2, 3]
    with pytest.raises(ValueError, match="leading axis of 6 does not split "
                                         "over 4 ranks"):
        parallel.shard_rows(torch.arange(6), mesh)
    with parallel.sharded(mesh):
        got = parallel.global_draw(lambda s: torch.arange(s[0] * 3).reshape(
            s[0], 3), (2, 3))
    assert got.tolist() == [[6, 7, 8], [9, 10, 11]]
