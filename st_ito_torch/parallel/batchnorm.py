"""Global-batch BatchNorm for train mode over a mesh.

The JAX trainers' BatchNorm, sharded over "data", normalises by the
statistics of the global batch and updates its running statistics with
them. Per-rank ``nn.BatchNorm`` statistics differ from that at every step
and the ranks' buffers drift apart; ``torch.nn.SyncBatchNorm`` refuses CPU
input. Here the statistics are two differentiable all-reduces of per-channel
sums: the sum (for the mean), then the sum of squares about that mean (for
the biased variance, two passes, so no cancellation between a large mean
and a small spread). Their backward all-reduces the two gradient sums, so a
rank's input gradient carries every rank's loss, as one process's does on
the whole batch. The running statistics take the global mean and the
unbiased global variance, with the module's momentum. Every rank must hold
the same number of rows (the mesh's shards are equal).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from st_ito_torch.parallel.collectives import all_reduce_sum


def global_batch_norm(x: torch.Tensor, running_mean, running_var, weight,
                      bias, training: bool, momentum: float, eps: float,
                      mesh) -> torch.Tensor:
    """``F.batch_norm`` over channel axis 1 with the batch statistics of
    every rank's x together. Outside train mode (or at world size 1) it is
    ``F.batch_norm`` itself."""
    if not training or mesh.world_size == 1:
        return torch.nn.functional.batch_norm(
            x, running_mean, running_var, weight, bias, training,
            momentum, eps)
    dims = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    n = x.numel() // x.shape[1] * mesh.world_size
    mean = all_reduce_sum(x.sum(dims), mesh) / n
    xc = x - mean.reshape(shape)
    var = all_reduce_sum((xc * xc).sum(dims), mesh) / n
    y = xc * torch.rsqrt(var + eps).reshape(shape)
    if weight is not None:
        y = y * weight.reshape(shape) + bias.reshape(shape)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(mean.detach(),
                                                 alpha=momentum)
            running_var.mul_(1 - momentum).add_(
                var.detach() * (n / (n - 1)), alpha=momentum)
    return y


def _forward(bn: nn.modules.batchnorm._BatchNorm, mesh):
    def forward(x):
        bn._check_input_dim(x)
        training = bn.training or bn.running_mean is None
        track = bn.training and bn.track_running_stats
        if track:
            bn.num_batches_tracked.add_(1)  # a buffer of the state, as nn's
        return global_batch_norm(
            x, bn.running_mean if track or not bn.training else None,
            bn.running_var if track or not bn.training else None,
            bn.weight, bn.bias, training, bn.momentum, bn.eps, mesh)

    return forward


@contextlib.contextmanager
def global_batchnorm(module: nn.Module, mesh):
    """Inside, every BatchNorm of ``module`` runs ``global_batch_norm``
    over ``mesh`` (world size 1: the modules as they are)."""
    bns = [m for m in module.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    if mesh.world_size == 1 or not bns:
        yield
        return
    for bn in bns:
        bn.forward = _forward(bn, mesh)
    try:
        yield
    finally:
        for bn in bns:
            del bn.forward
