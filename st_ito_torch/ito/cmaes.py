"""CMA-ES (covariance matrix adaptation evolution strategy) on the host —
the port's own copy of ``st_ito_tpu/ito/cmaes.py``, pure numpy.

The standard (mu/mu_w, lambda) algorithm of Hansen's tutorial (step-size
control by the cumulative path, rank-one and rank-mu covariance update) in
float64, box constraints by reflection at the bounds. Its draws come from
``np.random.default_rng(seed)``, so for the same seed and the same fitness
ranking it asks for the same populations as the JAX package's, bit for bit.
``run_es`` runs it at ``gens_per_dispatch=1`` and under ``savepop``;
``run_es_multitrack`` runs one per track.
"""

from __future__ import annotations

import math

import numpy as np


def _reflect(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Reflect out-of-bounds coordinates back into [lo, hi]."""
    span = hi - lo
    y = (x - lo) % (2.0 * span)
    y = np.where(y > span, 2.0 * span - y, y)
    return y + lo


class CMAES:
    def __init__(
        self,
        x0: np.ndarray,
        sigma0: float,
        popsize: int | None = None,
        bounds: tuple[float, float] | None = (0.0, 1.0),
        seed: int = 0,
    ):
        x0 = np.asarray(x0, np.float64)
        self.N = N = x0.size
        self.lam = popsize if popsize is not None else 4 + int(3 * math.log(N))
        self.mu = self.lam // 2
        w = math.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights**2)

        self.cc = (4 + self.mueff / N) / (N + 4 + 2 * self.mueff / N)
        self.cs = (self.mueff + 2) / (N + self.mueff + 5)
        self.c1 = 2 / ((N + 1.3) ** 2 + self.mueff)
        self.cmu = min(
            1 - self.c1,
            2 * (self.mueff - 2 + 1 / self.mueff) / ((N + 2) ** 2 + self.mueff),
        )
        self.damps = 1 + 2 * max(0, math.sqrt((self.mueff - 1) / (N + 1)) - 1) + self.cs
        self.chiN = math.sqrt(N) * (1 - 1 / (4 * N) + 1 / (21 * N**2))

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
        self.generation = 0

        self.best_x = x0.copy()
        self.best_f = np.inf
        self._pending_z: np.ndarray | None = None

    # -- API mirroring cma.CMAEvolutionStrategy ----------------------------

    @property
    def result(self):
        """(xbest, fbest) like cma's result tuple prefix."""
        return (self.best_x.copy(), self.best_f)

    def ask(self) -> np.ndarray:
        """Sample lam candidates, shape (lam, N)."""
        z = self.rng.standard_normal((self.lam, self.N))
        y = z @ (self.B * self.D).T  # B @ diag(D) @ z
        x = self.mean[None, :] + self.sigma * y
        if self.bounds is not None:
            x = _reflect(x, self.bounds[0], self.bounds[1])
        self._pending_x = x
        return x

    def tell(self, X: np.ndarray, fvals) -> None:
        X = np.asarray(X, np.float64)
        fvals = np.asarray(fvals, np.float64)
        self.counteval += len(fvals)
        self.generation += 1

        order = np.argsort(fvals)
        if fvals[order[0]] < self.best_f:
            self.best_f = float(fvals[order[0]])
            self.best_x = X[order[0]].copy()

        X_sel = X[order[: self.mu]]
        old_mean = self.mean
        self.mean = self.weights @ X_sel

        y_mean = (self.mean - old_mean) / self.sigma
        C_inv_sqrt = self.B @ np.diag(1.0 / self.D) @ self.B.T
        self.ps = (1 - self.cs) * self.ps + math.sqrt(
            self.cs * (2 - self.cs) * self.mueff
        ) * (C_inv_sqrt @ y_mean)

        hsig = float(
            np.linalg.norm(self.ps)
            / math.sqrt(1 - (1 - self.cs) ** (2 * self.counteval / self.lam))
            / self.chiN
            < 1.4 + 2 / (self.N + 1)
        )
        self.pc = (1 - self.cc) * self.pc + hsig * math.sqrt(
            self.cc * (2 - self.cc) * self.mueff
        ) * y_mean

        artmp = (X_sel - old_mean[None, :]) / self.sigma
        self.C = (
            (1 - self.c1 - self.cmu) * self.C
            + self.c1
            * (
                np.outer(self.pc, self.pc)
                + (1 - hsig) * self.cc * (2 - self.cc) * self.C
            )
            + self.cmu * (artmp.T * self.weights) @ artmp
        )

        self.sigma *= math.exp(
            (self.cs / self.damps) * (np.linalg.norm(self.ps) / self.chiN - 1)
        )
        self.sigma = min(self.sigma, 1e3)

        # refresh eigendecomposition
        self.C = (self.C + self.C.T) / 2
        d2, self.B = np.linalg.eigh(self.C)
        self.D = np.sqrt(np.maximum(d2, 1e-20))

    def disp(self) -> None:
        print(
            f"gen {self.generation:4d}  evals {self.counteval:6d}  "
            f"fbest {self.best_f:+.6f}  sigma {self.sigma:.4f}"
        )

    def state_dict(self) -> dict:
        """Snapshot for ES-state checkpoint/resume."""
        return {
            "mean": self.mean, "sigma": self.sigma, "pc": self.pc,
            "ps": self.ps, "C": self.C, "best_x": self.best_x,
            "best_f": self.best_f, "counteval": self.counteval,
            "generation": self.generation,
        }

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            if isinstance(v, np.ndarray) and v.ndim == 0:
                v = v.item()
            setattr(self, k, v.copy() if isinstance(v, np.ndarray) else v)
        self.sigma = float(self.sigma)
        self.best_f = float(self.best_f)
        self.counteval = int(self.counteval)
        self.generation = int(self.generation)
        self.C = (self.C + self.C.T) / 2
        d2, self.B = np.linalg.eigh(self.C)
        self.D = np.sqrt(np.maximum(d2, 1e-20))
