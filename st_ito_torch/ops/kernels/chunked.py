"""What the chunked scans share: the chunk length and the accuracy rules.

K1 (``eqcomp``), K6, K7, K8 and K11 (``scan``) cut T into chunks of
``chunk_len`` samples, each walked by its own warp from the state it starts
in, and pass the state between chunks through a carry table (``rows``
floats per chunk and lane, ``csrc/scan_core.cuh``, ``csrc/scan.cu``). The
carries round differently from the serial chain of the plain versions, so
the kernels are held to two rules (``gate_excess``) in place of bitwise
equality; the first chunk starts from rest, as the serial chain does, and
stays bitwise equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Enough (32-lane block, chunk) warps to fill the card (132 SMs x 62),
# chunks of at least MIN_CHUNK samples, and a carry table of at most
# TABLE_CAP bytes, past which the chunks grow instead of the table.
TARGET_WARPS = 8192
MIN_CHUNK = 256
TABLE_CAP = 64 << 20
# A lane that misses rule (a) while the float32 plain run lies within 1e-4 x
# peak of float64 is excused only where the kernel lies at most this many
# times as far from float64 as the plain run does (``a_miss_unexcused``).
A_EXCUSE = 1.25


def chunk_len(lanes: int, T: int, rows: int) -> int:
    """The chunk length for (lanes, T) and a carry table of ``rows`` floats
    per chunk and lane: a multiple of the 32-sample tile."""
    want = -(-TARGET_WARPS // -(-lanes // 32))
    L = max(MIN_CHUNK, -(-(-(-T // want)) // 32) * 32)
    while lanes * -(-T // L) * rows * 4 > TABLE_CAP:
        L *= 2
    return L


def gate_excess(got, want32, want64=None, rule_a_lanes=None) -> dict:
    """How far a chunked kernel's output ``got`` (lanes, T) lies past its
    two rules; each value is <= 0 when the rule holds on every lane.

    (a) On the lanes ``rule_a_lanes`` (a bool mask; default every lane),
    max_t |got - want32| <= 1e-4 x max(1, max_t |want32|). (b) With the
    float64 run of the plain version ``want64``, on every lane,
    max_t |got - want64| <= 4 x max_t |want32 - want64| + 1e-5 x
    max(1, max_t |want64|). "a" is -inf where the mask holds no lane."""
    got, want32 = got.to(torch.float64), want32.to(torch.float64)
    peak32 = torch.clamp_min(want32.abs().amax(1), 1.0)
    err32 = (got - want32).abs().amax(1)
    held = (torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
            if rule_a_lanes is None else rule_a_lanes.to(got.device))
    out = {"a": float((err32 - 1e-4 * peak32)[held].max())
           if bool(held.any()) else -math.inf,
           "max_err_a": float(err32[held].max())
           if bool(held.any()) else 0.0,
           "max_err": float(err32.max())}
    if want64 is not None:
        want64 = want64.to(torch.float64)
        e_plain = (want32 - want64).abs().amax(1)
        e_got = (got - want64).abs().amax(1)
        peak64 = torch.clamp_min(want64.abs().amax(1), 1.0)
        out["b"] = float((e_got - 4.0 * e_plain - 1e-5 * peak64).max())
        out["max_err64"] = float(e_got.max())
        out["max_err64_plain"] = float(e_plain.max())
        # the lanes that miss (a) where the float32 plain run itself lies
        # past 1e-4 x peak of the float64 one, those that miss it where it
        # does not, and of these the ones where the kernel lies farther
        # than A_EXCUSE x the plain run's distance from float64
        miss = held & (err32 > 1e-4 * peak32)
        plain_far = e_plain > 1e-4 * peak64
        near = miss & ~plain_far
        out["a_miss_plain_far"] = int((miss & plain_far).sum())
        out["a_miss_plain_near"] = int(near.sum())
        out["a_miss_unexcused"] = int((near & (e_got > A_EXCUSE * e_plain))
                                      .sum())
    return out


# The plain versions' serial chain steps one time step at a time over all
# lanes. On the card it runs torch's operations on x's views; on the CPU
# numpy's on the same values: each numpy float32 or float64 operation
# rounds as torch's CPU one does (a product, then a sum, each rounded on its
# own), so the result is the same bit for bit, at a few times less overhead
# a call than torch's at a time step's lane counts. A loop written with +,
# -, * and the names both modules share (``minimum``, ``zeros_like``)
# serves both; ``tests/test_torch_serial_loops.py`` holds the two equal.


def on_host(t: torch.Tensor) -> bool:
    """Whether the serial chain runs t's steps in numpy (t on the CPU)."""
    return t.device.type == "cpu"


def host(t: torch.Tensor):
    """t as the serial chain takes it: a numpy view on the CPU, else t."""
    return t.detach().numpy() if on_host(t) else t


def array_module(t: torch.Tensor):
    """numpy for a tensor on the CPU, else torch."""
    return np if on_host(t) else torch


def serial_steps(x: torch.Tensor):
    """x (lanes, T) as its T time steps of (lanes,), in ``host``'s form. On
    the CPU numpy's overflow warnings are off while the loop runs over them,
    as torch has none."""
    if not on_host(x):
        yield from x.unbind(-1)
        return
    with np.errstate(over="ignore", invalid="ignore"):
        yield from np.ascontiguousarray(x.detach().numpy().T)


def serial_stack(cols, like: torch.Tensor) -> torch.Tensor:
    """The chain's T outputs of (lanes,) as a (lanes, T) tensor on like's
    device."""
    if on_host(like):
        return torch.from_numpy(np.stack(cols, axis=1))
    return torch.stack(cols, dim=1)
