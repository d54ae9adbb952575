"""Simulation data generator (paper Section 4.1) and the Lemma 4.1 oracle.

NumPy only: a copy of ``repro.core.simulate`` kept in the port so that it
never imports the JAX package (whose ``core/__init__`` imports jax);
the same seed gives bit-equal output.

Covariates are Gaussian-mixture: x ~ N(mu_+, Sigma) when Y=1 and
N(mu_-, Sigma) when Y=-1, with mu_+ = -mu_- = (mu 1_s, 0_{p-s}); Sigma is
block diagonal with AR(rho) blocks of sizes s and (p-s).  Labels flip with
probability p_flip.  A leading intercept column X_1 == 1 is prepended, so
designs have p+1 columns and the Lemma 4.1 truth has the intercept first
(zero here, since mu_+ + mu_- = 0).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _norm_pdf(a: float) -> float:
    return math.exp(-0.5 * a * a) / math.sqrt(2.0 * math.pi)


def _norm_cdf(a: float) -> float:
    return 0.5 * (1.0 + math.erf(a / math.sqrt(2.0)))


def _inverse_mills(a: float) -> float:
    """gamma(a) = phi(a) / Phi(a) — strictly decreasing on R."""
    return _norm_pdf(a) / max(_norm_cdf(a), 1e-300)


def _gamma_inverse(target: float, lo: float = -40.0, hi: float = 40.0) -> float:
    """Solve gamma(a) = target by bisection (gamma is decreasing)."""
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _inverse_mills(mid) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def ar_cov(dim: int, rho: float) -> np.ndarray:
    idx = np.arange(dim)
    return rho ** np.abs(idx[:, None] - idx[None, :])


@dataclasses.dataclass(frozen=True)
class SimConfig:
    p: int = 100            # number of (non-intercept) covariates
    s: int = 10             # sparsity (# informative covariates)
    mu: float = 0.4         # mean shift
    rho: float = 0.5        # AR correlation within blocks
    p_flip: float = 0.01    # label-flip probability
    m: int = 10             # number of nodes
    n: int = 200            # local sample size
    graph: str = "erdos_renyi"
    p_connect: float = 0.5

    @property
    def n_total(self) -> int:
        return self.m * self.n


def true_beta(cfg: SimConfig) -> np.ndarray:
    """Lemma 4.1 population separating hyperplane (intercept first).

    beta* = (beta_1*, beta_-*) with
      beta_1* = -(mu_+-mu_-)' Sigma^-1 (mu_+ + mu_-) / A   (= 0 here)
      beta_-* = 2 Sigma^-1 (mu_+ - mu_-) / A
      A = 2 a* d + d^2,  d = Mahalanobis(mu_+, mu_-),  a* = gamma^{-1}(d/2).
    """
    p, s = cfg.p, cfg.s
    mu_plus = np.zeros(p)
    mu_plus[:s] = cfg.mu
    mu_minus = -mu_plus
    Sigma = np.zeros((p, p))
    Sigma[:s, :s] = ar_cov(s, cfg.rho)
    Sigma[s:, s:] = ar_cov(p - s, cfg.rho)
    diff = mu_plus - mu_minus
    sol = np.linalg.solve(Sigma, diff)
    d = math.sqrt(float(diff @ sol))
    a_star = _gamma_inverse(d / 2.0)
    A = 2.0 * a_star * d + d * d
    beta0 = -float(sol @ (mu_plus + mu_minus)) / A  # zero by symmetry
    slope = 2.0 * sol / A
    return np.concatenate([[beta0], slope]).astype(np.float64)


def generate(cfg: SimConfig, seed: int = 0):
    """Generate node-partitioned data.

    Returns:
      X: (m, n, p+1) float32 with intercept column; y: (m, n) in {-1, +1};
      beta_star: (p+1,) the Lemma 4.1 population parameter.
    """
    rng = np.random.default_rng(seed)
    p, s, m, n = cfg.p, cfg.s, cfg.m, cfg.n
    N = m * n
    y = rng.choice(np.array([1.0, -1.0]), size=N)
    mu_vec = np.zeros(p)
    mu_vec[:s] = cfg.mu
    # Sample block-wise: chol of each AR block.
    L_s = np.linalg.cholesky(ar_cov(s, cfg.rho))
    L_r = np.linalg.cholesky(ar_cov(p - s, cfg.rho)) if p > s else None
    Z = rng.standard_normal((N, p))
    X = np.empty((N, p))
    X[:, :s] = Z[:, :s] @ L_s.T
    if L_r is not None:
        X[:, s:] = Z[:, s:] @ L_r.T
    X += y[:, None] * mu_vec[None, :]
    # Label flips.
    flip = rng.random(N) < cfg.p_flip
    y = np.where(flip, -y, y)
    Xi = np.concatenate([np.ones((N, 1)), X], axis=1)
    Xi = Xi.reshape(m, n, p + 1).astype(np.float32)
    y = y.reshape(m, n).astype(np.float32)
    return Xi, y, true_beta(cfg)
