"""Weights drawn from the run's seed on the card, the same for the program
and the reference: one uniform draw from a ``torch.Generator`` on the
device for all tensors, split and scaled per tensor by its kind."""

from __future__ import annotations

import math

import torch


def draw(seed: int, specs, device, dtype=torch.float32) -> dict:
    """name -> tensor for ``specs`` [(name, shape, kind)]: Xavier-uniform
    convolution and linear weights, biases in +-0.01, BatchNorm scales in
    [0.8, 1.2], shifts and running means in +-0.1, running variances in
    [0.5, 1.5], step counters 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.rand(sum(sizes), generator=gen, device=device,
                      dtype=torch.float32) * 2.0 - 1.0  # U(-1, 1)
    out, at = {}, 0
    for (name, shape, kind), size in zip(specs, sizes):
        u = flat[at:at + size].reshape(shape)
        at += size
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        if kind in ("conv", "linear"):
            receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
            a = math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
            t = u * a
        elif kind == "bias":
            t = u * 0.01
        elif kind == "bn_weight":
            t = 1.0 + 0.2 * u
        elif kind in ("bn_bias", "bn_mean"):
            t = 0.1 * u
        elif kind == "bn_var":
            t = 1.0 + 0.5 * u
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = t.to(dtype).clone()
    return out
