"""Plain CMA-ES, the reference the ITO cells replay a search with.

The (mu/mu_w, lambda) algorithm of Hansen's tutorial ("The CMA Evolution
Strategy: A Tutorial", 2016) as ST-ITO runs it: log-rank weights over the
best half, step size by the cumulative path, rank-one and rank-mu
covariance updates, box bounds by reflection, every draw from
``np.random.default_rng(seed)`` (one standard-normal matrix an ask) in
float64. Told the same fitness values, it asks for the same populations as
the program's host CMA-ES, bit for bit, which is what lets the check
follow a job's search from its seed.
"""

from __future__ import annotations

import math

import numpy as np


def reflect(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    span = hi - lo
    y = (x - lo) % (2.0 * span)
    y = np.where(y > span, 2.0 * span - y, y)
    return y + lo


class CMAES:
    def __init__(self, x0, sigma0: float, popsize: int, seed: int,
                 bounds=(0.0, 1.0)):
        x0 = np.asarray(x0, np.float64)
        self.N = N = x0.size
        self.lam = popsize
        self.mu = popsize // 2
        w = math.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights ** 2)
        self.cc = (4 + self.mueff / N) / (N + 4 + 2 * self.mueff / N)
        self.cs = (self.mueff + 2) / (N + self.mueff + 5)
        self.c1 = 2 / ((N + 1.3) ** 2 + self.mueff)
        self.cmu = min(1 - self.c1, 2 * (self.mueff - 2 + 1 / self.mueff)
                       / ((N + 2) ** 2 + self.mueff))
        self.damps = (1 + 2 * max(0, math.sqrt((self.mueff - 1) / (N + 1))
                                  - 1) + self.cs)
        self.chiN = math.sqrt(N) * (1 - 1 / (4 * N) + 1 / (21 * N ** 2))
        self.mean = x0.copy()
        self.sigma = float(sigma0)
        self.pc = np.zeros(N)
        self.ps = np.zeros(N)
        self.C = np.eye(N)
        self.B = np.eye(N)
        self.D = np.ones(N)
        self.bounds = bounds
        self.rng = np.random.default_rng(seed)
        self.counteval = 0

    def ask(self) -> np.ndarray:
        z = self.rng.standard_normal((self.lam, self.N))
        x = self.mean[None, :] + self.sigma * (z @ (self.B * self.D).T)
        return reflect(x, *self.bounds)

    def tell(self, X, fvals) -> None:
        X = np.asarray(X, np.float64)
        fvals = np.asarray(fvals, np.float64)
        self.counteval += len(fvals)
        X_sel = X[np.argsort(fvals)[: self.mu]]
        old_mean = self.mean
        self.mean = self.weights @ X_sel
        y_mean = (self.mean - old_mean) / self.sigma
        C_inv_sqrt = self.B @ np.diag(1.0 / self.D) @ self.B.T
        self.ps = (1 - self.cs) * self.ps + math.sqrt(
            self.cs * (2 - self.cs) * self.mueff) * (C_inv_sqrt @ y_mean)
        hsig = float(np.linalg.norm(self.ps) / math.sqrt(
            1 - (1 - self.cs) ** (2 * self.counteval / self.lam))
            / self.chiN < 1.4 + 2 / (self.N + 1))
        self.pc = (1 - self.cc) * self.pc + hsig * math.sqrt(
            self.cc * (2 - self.cc) * self.mueff) * y_mean
        artmp = (X_sel - old_mean[None, :]) / self.sigma
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (np.outer(self.pc, self.pc) + (1 - hsig)
                               * self.cc * (2 - self.cc) * self.C)
                  + self.cmu * (artmp.T * self.weights) @ artmp)
        self.sigma *= math.exp((self.cs / self.damps)
                               * (np.linalg.norm(self.ps) / self.chiN - 1))
        self.sigma = min(self.sigma, 1e3)
        self.C = (self.C + self.C.T) / 2
        d2, self.B = np.linalg.eigh(self.C)
        self.D = np.sqrt(np.maximum(d2, 1e-20))
