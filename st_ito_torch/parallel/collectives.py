"""The collectives the mesh's users need, and the global random draws.

Under gloo a tensor on the card goes through host memory: gloo's all-gather
and gather take CPU tensors only. That is the gloo path on the card (several
ranks sharing one card), not a fallback; NCCL keeps every collective on the
card.

``sharded(mesh)`` makes the mesh the active one for the code inside: every
random draw of a per-row tensor goes through ``global_draw``, which draws
the global leading size from the generator and keeps this rank's rows, so
that each rank's masks are its rows of world size 1's and every rank's
generator advances exactly as world size 1's does. With ``module``, its
train-mode BatchNorms normalise by the global batch's statistics
(``parallel/batchnorm.py``). At world size 1 nothing changes.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_ACTIVE: list = []  # the meshes of the enclosing ``sharded`` scopes


def _single(mesh) -> bool:
    """No mesh, or a mesh of one rank: every collective is the identity."""
    return mesh is None or mesh.world_size == 1


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """t where the backend can take it: on the host under gloo."""
    return t.cpu() if mesh.backend == "gloo" else t


def shard_rows(x, mesh):
    """This rank's block of x's leading axis; raises unless the axis
    divides over the ranks."""
    n, w = x.shape[0], mesh.world_size
    if n % w:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{w} ranks of the {mesh.axis_name!r} mesh")
    k = n // w
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along axis 0 in rank
    order, on every rank, on x's device."""
    if _single(mesh):
        return x
    t = _staged(mesh, x.contiguous())
    out = torch.empty((t.shape[0] * mesh.world_size, *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, t, group=mesh.group)
    else:
        dist.all_gather(list(out.chunk(mesh.world_size)), t,
                        group=mesh.group)
    return out.to(x.device)


def gather_rows_to_root(x: torch.Tensor, mesh):
    """Every rank's x concatenated along axis 0 on rank 0; None on the
    others."""
    if _single(mesh):
        return x
    t = _staged(mesh, x.contiguous())
    parts = ([torch.empty_like(t) for _ in range(mesh.world_size)]
             if mesh.rank == 0 else None)
    dist.gather(t, parts, dst=0, group=mesh.group)
    return torch.cat(parts).to(x.device) if mesh.rank == 0 else None


def _all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    s = _staged(mesh, t.contiguous().clone())
    dist.all_reduce(s, op=op, group=mesh.group)
    return s.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its gradient is the sum over ranks of the
    ranks' gradients (each rank's loss takes part in every rank's sum)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of t over the ranks, differentiable."""
    if _single(mesh):
        return t
    return _AllReduceSum.apply(t, mesh)


def all_reduce_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of t over the ranks (no gradient)."""
    if _single(mesh):
        return t
    return _all_reduce(t.detach(), mesh) / mesh.world_size


def all_reduce_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of t over the ranks (no gradient)."""
    if _single(mesh):
        return t
    return _all_reduce(t.detach(), mesh, dist.ReduceOp.MAX)


def average_gradients(params, mesh) -> None:
    """Each parameter's gradient replaced by its mean over the ranks, in
    one flat all-reduce."""
    if _single(mesh):
        return
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    flat = _all_reduce(flat, mesh) / mesh.world_size
    i = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[i:i + n].view_as(p.grad))
        i += n


def active():
    """The mesh of the innermost ``sharded`` scope, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def batch_max(t: torch.Tensor) -> torch.Tensor:
    """t, a max over this rank's rows of a batch, made the max over the
    global batch inside a ``sharded`` scope (no gradient)."""
    return all_reduce_max(t, active())


def global_draw(draw, shape):
    """``draw(shape)``, a draw from a generator of a tensor whose axis 0
    is the batch's. Inside a ``sharded`` scope of world size w it draws
    ``(w shape[0], *shape[1:])`` and returns this rank's rows."""
    mesh = active()
    shape = tuple(shape)
    if _single(mesh):
        return draw(shape)
    n = shape[0]
    full = draw((n * mesh.world_size, *shape[1:]))
    return full[mesh.rank * n:(mesh.rank + 1) * n]


@contextlib.contextmanager
def sharded(mesh, module=None):
    """Inside: ``global_draw`` draws over ``mesh``'s global leading axis,
    and ``module``'s train-mode BatchNorms normalise by global batch
    statistics. None, or world size 1, changes nothing."""
    if _single(mesh):
        yield
        return
    from st_ito_torch.parallel.batchnorm import global_batchnorm

    _ACTIVE.append(mesh)
    try:
        with (global_batchnorm(module, mesh) if module is not None
              else contextlib.nullcontext()):
            yield
    finally:
        _ACTIVE.pop()
