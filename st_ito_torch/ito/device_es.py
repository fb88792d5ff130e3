"""Device-resident CMA-ES — port of ``st_ito_tpu/ito/device_es.py``.

The standard Hansen (mu/mu_w, lambda) update in float32 on the device that
holds the population: sampling, reflection into [0, 1], rank-mu covariance
update, step-size control and the ``torch.linalg.eigh`` covariance refresh.
``make_block_runner`` runs k generations and keeps their statistics on the
device, so the caller fetches one (k, N + 2) array per block.
``state_to_dict`` and ``state_from_dict`` read and write the snapshot layout
of the host ``CMAES.state_dict`` (the JAX package's keys, float64), so a
snapshot written by either package, in either form, resumes in the other.

Random numbers come from a ``torch.Generator`` on the device (they differ
from ``jax.random``'s); ``cma_ask`` also takes injected normals so tests can
feed both implementations the same draws.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from st_ito_torch.utils import phase_timer


class CMAConsts(NamedTuple):
    """Static strategy parameters."""

    N: int
    lam: int
    mu: int
    weights: torch.Tensor  # (mu,) float32, on the device
    mueff: float
    cc: float
    cs: float
    c1: float
    cmu: float
    damps: float
    chiN: float


class CMAState(NamedTuple):
    """Evolving state, float32 tensors on the device; counters on the
    host (they advance by known amounts, so reading them needs no sync)."""

    mean: torch.Tensor  # (N,)
    sigma: torch.Tensor  # ()
    pc: torch.Tensor  # (N,)
    ps: torch.Tensor  # (N,)
    C: torch.Tensor  # (N, N)
    B: torch.Tensor  # (N, N) eigenbasis of C
    D: torch.Tensor  # (N,) sqrt eigenvalues
    best_x: torch.Tensor  # (N,)
    best_f: torch.Tensor  # ()
    generation: int
    counteval: int


def cma_consts(N: int, popsize: int, device) -> CMAConsts:
    lam = popsize
    mu = lam // 2
    w = math.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w = w / w.sum()
    mueff = 1.0 / float(np.sum(w**2))
    cc = (4 + mueff / N) / (N + 4 + 2 * mueff / N)
    cs = (mueff + 2) / (N + mueff + 5)
    c1 = 2 / ((N + 1.3) ** 2 + mueff)
    cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((N + 2) ** 2 + mueff))
    damps = 1 + 2 * max(0.0, math.sqrt((mueff - 1) / (N + 1)) - 1) + cs
    chiN = math.sqrt(N) * (1 - 1 / (4 * N) + 1 / (21 * N**2))
    return CMAConsts(N, lam, mu,
                     torch.as_tensor(w, dtype=torch.float32, device=device),
                     mueff, cc, cs, c1, cmu, damps, chiN)


def cma_init(x0, sigma0: float, device) -> CMAState:
    x0 = torch.as_tensor(np.asarray(x0, np.float32), device=device)
    N = x0.numel()

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return CMAState(
        mean=x0.clone(), sigma=f32(sigma0),
        pc=torch.zeros(N, device=device), ps=torch.zeros(N, device=device),
        C=torch.eye(N, device=device), B=torch.eye(N, device=device),
        D=torch.ones(N, device=device), best_x=x0.clone(),
        best_f=f32(math.inf), generation=0, counteval=0)


def state_to_dict(state: CMAState) -> dict:
    """Fetch to the host in the ``CMAES.state_dict`` layout (float64)."""
    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    return {"mean": f64(state.mean), "sigma": float(state.sigma),
            "pc": f64(state.pc), "ps": f64(state.ps), "C": f64(state.C),
            "best_x": f64(state.best_x), "best_f": float(state.best_f),
            "counteval": int(state.counteval),
            "generation": int(state.generation)}


def state_from_dict(d: dict, device) -> CMAState:
    """The state of a snapshot, on ``device``; the eigenbasis of the
    symmetrised covariance is formed in float64 on the host, as the JAX
    package forms it."""
    C = np.asarray(d["C"], np.float64)
    C = (C + C.T) / 2
    d2, B = np.linalg.eigh(C)
    D = np.sqrt(np.maximum(d2, 1e-20))

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return CMAState(mean=f32(d["mean"]), sigma=f32(float(d["sigma"])),
                    pc=f32(d["pc"]), ps=f32(d["ps"]), C=f32(C), B=f32(B),
                    D=f32(D), best_x=f32(d["best_x"]),
                    best_f=f32(float(d["best_f"])),
                    generation=int(d["generation"]),
                    counteval=int(d["counteval"]))


def _reflect01(x: torch.Tensor) -> torch.Tensor:
    """Reflect out-of-bounds coordinates back into [0, 1]."""
    y = torch.remainder(x, 2.0)
    return torch.where(y > 1.0, 2.0 - y, y)


def cma_ask(state: CMAState, consts: CMAConsts,
            generator: torch.Generator | None = None,
            z: torch.Tensor | None = None) -> torch.Tensor:
    """(lam, N) candidates: standard normals ``z`` (drawn from
    ``generator``, a generator on the state's device, unless given) mapped
    through B diag(D), scaled by sigma, shifted by the mean, reflected."""
    if z is None:
        z = torch.randn((consts.lam, consts.N), generator=generator,
                        device=state.mean.device, dtype=torch.float32)
    y = z @ (state.B * state.D[None, :]).T  # rows: B @ diag(D) @ z_i
    return _reflect01(state.mean[None, :] + state.sigma * y)


def cma_tell(state: CMAState, consts: CMAConsts, X: torch.Tensor,
             fvals: torch.Tensor) -> CMAState:
    N, lam, mu = consts.N, consts.lam, consts.mu
    counteval = state.counteval + lam
    generation = state.generation + 1

    order = torch.argsort(fvals, stable=True)
    gen_best_f = fvals[order[0]]
    gen_best_x = X[order[0]]
    improved = gen_best_f < state.best_f
    best_f = torch.where(improved, gen_best_f, state.best_f)
    best_x = torch.where(improved, gen_best_x, state.best_x)

    X_sel = X[order[:mu]]  # (mu, N)
    old_mean = state.mean
    mean = consts.weights @ X_sel

    y_mean = (mean - old_mean) / state.sigma
    C_inv_sqrt = state.B @ ((1.0 / state.D)[:, None] * state.B.T)
    ps = (1 - consts.cs) * state.ps + math.sqrt(
        consts.cs * (2 - consts.cs) * consts.mueff) * (C_inv_sqrt @ y_mean)

    decay = torch.tensor(1 - consts.cs, dtype=torch.float32) ** torch.tensor(
        2.0 * counteval / lam, dtype=torch.float32)
    hsig = (torch.linalg.norm(ps) / torch.sqrt(1 - decay.to(ps.device))
            / consts.chiN < 1.4 + 2 / (N + 1)).to(torch.float32)
    pc = (1 - consts.cc) * state.pc + hsig * math.sqrt(
        consts.cc * (2 - consts.cc) * consts.mueff) * y_mean

    artmp = (X_sel - old_mean[None, :]) / state.sigma
    C = ((1 - consts.c1 - consts.cmu) * state.C
         + consts.c1 * (torch.outer(pc, pc)
                        + (1 - hsig) * consts.cc * (2 - consts.cc) * state.C)
         + consts.cmu * (artmp.T * consts.weights[None, :]) @ artmp)

    sigma = state.sigma * torch.exp(
        (consts.cs / consts.damps) * (torch.linalg.norm(ps) / consts.chiN - 1.0))
    sigma = torch.clamp_max(sigma, 1e3)

    C = (C + C.T) / 2
    d2, B = torch.linalg.eigh(C)
    D = torch.sqrt(torch.clamp_min(d2, 1e-20))
    return CMAState(mean, sigma, pc, ps, C, B, D, best_x, best_f,
                    generation, counteval)


def lift_slice(template: torch.Tensor, W: torch.Tensor,
               s0: int) -> torch.Tensor:
    """Candidates W (lam, N) of the slice [s0, s0 + N) embedded into the
    full frozen parameter vector ``template`` (P,): (lam, P)."""
    Wf = template[None, :].repeat(W.shape[0], 1)
    Wf[:, s0:s0 + W.shape[1]] = W
    return Wf


def make_block_runner(fitness: Callable, consts: CMAConsts,
                      crop_len: int | None = None,
                      crop_min_start: int = 16384) -> Callable:
    """``run(state, x, target_embeds, k, generator, crop_generator,
    target_content_embeds=None, lift=None) -> (state, stats)`` runs k
    generations. ``fitness(W, x, target_embeds, target_content_embeds,
    generator)`` returns (lam,) fitness values on the device; it draws its
    embedding-dropout masks, if any, from ``generator``, the generator the
    asks draw from. When ``crop_len`` is given and x is longer, each
    generation scores the whole population on one random crop of x, its
    start drawn from ``crop_generator`` (a CPU generator, so drawing it
    needs no sync with the device).

    ``lift = (template (P,), start)`` (``run_es``'s ``opt_slice``): the
    candidates are the slice [start, start + N) of the full parameter
    vector, every other entry frozen at the template's value; the fitness
    sees the full vectors, the state and the statistics the slice.

    ``stats`` is the (k, N + 2) float32 device tensor of the JAX package's
    ``BlockStats.packed``: [:, 0] the best fitness OF each generation,
    [:, 1] best-so-far AFTER it, [:, 2:] the best-so-far candidate."""

    @torch.no_grad()
    def run(state: CMAState, x, target_embeds, k: int,
            generator: torch.Generator, crop_generator: torch.Generator,
            target_content_embeds=None, lift=None):
        T = x.shape[-1]
        do_crop = crop_len is not None and T > crop_len
        rows = []
        for _ in range(k):
            dev = state.mean.device
            with phase_timer.span("ask", dev):
                W = cma_ask(state, consts, generator)
            W_eval = W if lift is None else lift_slice(lift[0], W, lift[1])
            xe = x
            if do_crop:
                lo = min(crop_min_start, T - crop_len)
                start = int(torch.randint(lo, T - crop_len, (),
                                          generator=crop_generator))
                xe = x[..., start:start + crop_len]
            fvals = fitness(W_eval, xe, target_embeds, target_content_embeds,
                            generator).to(torch.float32)
            with phase_timer.span("tell", dev):
                state = cma_tell(state, consts, W, fvals)
            rows.append(torch.cat([fvals.min()[None], state.best_f[None],
                                   state.best_x]))
        return state, torch.stack(rows)

    return run
