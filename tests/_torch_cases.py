"""Seeded inputs shared by the torch port's kernel tests (CPU and CUDA);
numpy only, so that the CUDA tests run where jax is not installed."""
import numpy as np


def problem(m, n, p, seed=0, scale_b=0.05):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n, p)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], (m, n)).astype(np.float32)
    W = np.triu((rng.random((m, m)) < 0.6).astype(np.float32), 1)
    W = W + W.T
    deg = W.sum(1).astype(np.float32)
    rho = rng.uniform(1.0, 3.0, m).astype(np.float32) * (p / 8)
    omega = (1.0 / (2.0 * deg + rho + 0.1)).astype(np.float32)
    B = (rng.standard_normal((m, p)) * scale_b).astype(np.float32)
    P = (rng.standard_normal((m, p)) * 0.01).astype(np.float32)
    lam = rng.uniform(0.002, 0.02, p).astype(np.float32)
    neigh = (1.0 * (deg[:, None] * B + W @ B)).astype(np.float32)
    return dict(X=X, y=y, W=W, deg=deg, rho=rho, omega=omega, B=B, P=P,
                lam=lam, neigh=neigh)


# (m, n, p, num_rounds, nact, want_kkt, lam0, lam_vector, kernel):
# m not a multiple of 8 and n not a multiple of 16 (the JAX wrapper pads
# both), held rounds, nact = 0, lambda vectors and lam0 > 0.  The last two
# give the stream instance of the CUDA round kernel block ranges that cross
# node boundaries at its own grid (6 blocks of 30 rows over 45-row nodes;
# 5 over 50-row nodes), one with rows a multiple of 16 bytes (p = 24), one
# ragged (p = 13).
ROUND_CASES = [
    (5, 13, 37, 3, 3, False, 0.0, False, "epanechnikov"),
    (5, 13, 37, 4, 2, True, 0.1, True, "epanechnikov"),
    (3, 20, 9, 4, 0, False, 0.0, True, "gaussian"),
    (3, 20, 9, 3, 0, True, 0.2, False, "laplacian"),
    (6, 17, 130, 5, 5, True, 0.0, True, "logistic"),
    (4, 45, 24, 3, 3, True, 0.05, True, "epanechnikov"),
    (3, 50, 13, 4, 3, False, 0.0, True, "uniform"),
]
