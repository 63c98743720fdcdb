"""Minimal CMA-ES (ask/tell) for low-dimensional policy-parameter search.

A copy of ``montecarlo_tpu/models/cma.py`` (numpy only; the JAX package's
``models/__init__.py`` imports jax, so the port keeps its own copy, and
``tests/test_torch_cma.py`` holds the two equal draw for draw). It drives
the adaptive rule-bot attacker (``scripts/opt_bot.py``).

Standard (mu/mu_w, lambda)-CMA-ES (Hansen's tutorial formulas: rank-one
+ rank-mu covariance update, cumulative step-size adaptation). Fitness is
MAXIMIZED. Evaluations are batched per generation (the caller feeds them
to the population league kernel in one launch) and may be noisy: use
common random numbers per generation and select the final answer with a
fixed holdout evaluation, not the per-generation argmax.
"""

from __future__ import annotations

import numpy as np


class CMAES:
    def __init__(self, x0, sigma0: float, popsize: int | None = None,
                 seed: int = 0, lower=None, upper=None):
        self.dim = len(x0)
        self.mean = np.asarray(x0, np.float64).copy()
        self.sigma = float(sigma0)
        self.lam = popsize or 4 + int(3 * np.log(self.dim))
        self.mu = self.lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mueff = 1.0 / np.sum(self.w ** 2)
        n = self.dim
        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mueff - 2 + 1 / self.mueff)
                       / ((n + 2) ** 2 + self.mueff))
        self.damps = (1 + 2 * max(0.0, np.sqrt((self.mueff - 1)
                                               / (n + 1)) - 1) + self.cs)
        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.chiN = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
        self.rng = np.random.default_rng(seed)
        self.gen = 0
        self.lower = None if lower is None else np.asarray(lower, np.float64)
        self.upper = None if upper is None else np.asarray(upper, np.float64)
        self._eig()

    def _eig(self):
        self.C = (self.C + self.C.T) / 2
        d, B = np.linalg.eigh(self.C)
        d = np.maximum(d, 1e-20)
        self.B, self.D = B, np.sqrt(d)

    def ask(self) -> np.ndarray:
        """[lam, dim] candidate matrix (clipped to bounds if given)."""
        z = self.rng.standard_normal((self.lam, self.dim))
        self._z = z
        x = self.mean[None] + self.sigma * (z * self.D[None]) @ self.B.T
        if self.lower is not None:
            x = np.maximum(x, self.lower[None])
        if self.upper is not None:
            x = np.minimum(x, self.upper[None])
        self._x = x
        return x

    def tell(self, fitness) -> None:
        """Rank by fitness (max) and update mean/covariance/step size."""
        f = np.asarray(fitness, np.float64)
        assert f.shape == (self.lam,)
        idx = np.argsort(-f)[: self.mu]
        xsel = self._x[idx]
        old_mean = self.mean
        self.mean = self.w @ xsel
        y = (self.mean - old_mean) / self.sigma
        # step-size path uses C^(-1/2) y
        cinv_y = self.B @ ((self.B.T @ y) / self.D)
        self.ps = ((1 - self.cs) * self.ps
                   + np.sqrt(self.cs * (2 - self.cs) * self.mueff) * cinv_y)
        hsig = (np.linalg.norm(self.ps)
                / np.sqrt(1 - (1 - self.cs) ** (2 * (self.gen + 1)))
                < (1.4 + 2 / (self.dim + 1)) * self.chiN)
        self.pc = ((1 - self.cc) * self.pc
                   + hsig * np.sqrt(self.cc * (2 - self.cc) * self.mueff) * y)
        ys = (xsel - old_mean[None]) / self.sigma
        rank_mu = (self.w[:, None, None]
                   * (ys[:, :, None] * ys[:, None, :])).sum(axis=0)
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (np.outer(self.pc, self.pc)
                               + (1 - hsig) * self.cc * (2 - self.cc) * self.C)
                  + self.cmu * rank_mu)
        self.sigma *= np.exp((self.cs / self.damps)
                             * (np.linalg.norm(self.ps) / self.chiN - 1))
        self.sigma = float(min(self.sigma, 1e3))
        self.gen += 1
        self._eig()
