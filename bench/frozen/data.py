"""The benchmark's data generator: frozen copies of the port's law.

``device_problem`` is a copy of ``repro_torch.launch.ranks.device_problem``
(the paper's §4.1 design drawn by torch on the card from a seed),
``ar_cov`` of ``repro_torch.core.simulate.ar_cov``, ``erdos_renyi`` of
``repro_torch.core.graph.erdos_renyi``, ``default_bandwidth`` of
``repro_torch.core.losses.default_bandwidth`` and ``log_grid`` of
``repro_torch.core.tuning._log_grid``.  They are copied, not imported, so
that a later change to the program cannot move the benchmark's inputs;
``bench/tests/test_bench_frozen.py`` shows that they still agree with the
port.  ``draw_pool`` draws a run's datasets a block at a time with the
Cholesky factors made once; a block of one dataset is ``device_problem``
bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def ar_cov(dim: int, rho: float) -> np.ndarray:
    idx = np.arange(dim)
    return rho ** np.abs(idx[:, None] - idx[None, :])


def default_bandwidth(n_total: int, p: int) -> float:
    """Paper §4.1: h = max{(log p / N)^(1/4), 0.05}."""
    return max((math.log(max(p, 2)) / max(n_total, 2)) ** 0.25, 0.05)


def log_grid(lam_max: float, num: int, min_frac: float) -> np.ndarray:
    """Log-spaced, decreasing from lam_max to lam_max * min_frac."""
    return np.logspace(math.log10(lam_max), math.log10(lam_max * min_frac),
                       num)


def erdos_renyi(m: int, p_connect: float, seed: int = 0,
                max_tries: int = 1000) -> np.ndarray:
    """Connected Erdős–Rényi graph G(m, p_c), resampled until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        upper = rng.random((m, m)) < p_connect
        W = np.triu(upper, 1)
        W = (W | W.T).astype(np.float32)
        if _connected(W):
            return W
    raise RuntimeError(f"could not sample a connected G({m},{p_connect})")


def _connected(W: np.ndarray) -> bool:
    m = W.shape[0]
    seen = np.zeros(m, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(W[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def _factors(p: int, s: int, rho: float, device) -> list:
    f64 = dict(dtype=torch.float64, device=device)
    out = []
    for lo, hi in ((0, s), (s, p)):
        if hi > lo:
            cov = torch.tensor(ar_cov(hi - lo, rho), **f64)
            out.append((lo, hi, torch.linalg.cholesky(cov).T))
    return out


def _draw(sim, seed: int, device, factors, count: int = 1):
    """``count`` datasets from one generator seeded with ``seed``: each
    draw of ``device_problem`` made for all of them at once, in its order
    (labels, the Gaussian block, flips), so that ``count = 1`` is
    ``device_problem`` bit for bit."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    p, s, m, n = sim.p, sim.s, sim.m, sim.n
    N = count * m * n
    y = 1.0 - 2.0 * (torch.rand(N, generator=g, **f64) < 0.5).double()
    Z = torch.randn(N, p, generator=g, **f64)
    X = torch.empty(N, p + 1, **f64)
    X[:, 0] = 1.0
    for lo, hi, cholT in factors:
        X[:, 1 + lo:1 + hi] = Z[:, lo:hi] @ cholT
    del Z
    X[:, 1:1 + s] += y[:, None] * sim.mu
    flip = torch.rand(N, generator=g, **f64) < sim.p_flip
    y = torch.where(flip, -y, y)
    return (X.reshape(count, m, n, p + 1).float(),
            y.reshape(count, m, n).float())


def device_problem(sim, seed: int, device):
    """A problem drawn by torch on ``device`` from ``seed`` under the law
    of the paper's §4.1: AR blocks by Cholesky factors in fp64, the mean
    shift on the first ``s`` coordinates, label flips, an intercept
    column.  Returns (X (m, n, p + 1), y (m, n)) as fp32 tensors."""
    X, y = _draw(sim, seed, device, _factors(sim.p, sim.s, sim.rho, device))
    return X[0], y[0]


def dataset_seeds(seed: int, count: int, stream: int = 0) -> list:
    """``count`` seeds derived from a run's seed (any whole number up to
    2**64 - 1) for one of its streams (0: the datasets' draws, 1: their
    networks), each below 2**63."""
    ss = np.random.SeedSequence([int(seed), int(stream)])
    return [int(v) for v in
            ss.generate_state(count, dtype=np.uint64) >> np.uint64(1)]


BLOCK_BYTES = 1 << 28


def block_size(sim) -> int:
    """How many datasets one draw makes: as many as fit ``BLOCK_BYTES`` of
    fp64 Gaussians, at least one."""
    return max(1, BLOCK_BYTES // (sim.m * sim.n * sim.p * 8))


def draw_pool(sim, seed: int, count: int, device):
    """``count`` datasets for a run's ``seed``, drawn in blocks of
    ``block_size(sim)``, block b from ``dataset_seeds(seed, ...)[b]``, with
    the Cholesky factors made once: (Xs, ys) lists of tensors.  A block of
    one is ``device_problem`` at its seed."""
    factors = _factors(sim.p, sim.s, sim.rho, device)
    size = block_size(sim)
    blocks = -(-count // size)
    Xs, ys = [], []
    for b, s in enumerate(dataset_seeds(seed, blocks)):
        k = min(size, count - b * size)
        X, y = _draw(sim, s, device, factors, k)
        Xs += list(X.unbind(0))
        ys += list(y.unbind(0))
    return Xs, ys
