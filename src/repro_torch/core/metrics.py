"""Evaluation metrics (paper Section 4.1).

NumPy only: a copy of ``repro.core.metrics`` kept in the port so that it never
imports the JAX package (whose ``core/__init__`` imports jax)."""
from __future__ import annotations

import numpy as np


def estimation_error(B: np.ndarray, beta_star: np.ndarray) -> float:
    """(sum_l |beta_l - beta*|_2^2 / m)^{1/2} averaged over nodes."""
    B = np.atleast_2d(np.asarray(B))
    d = B - np.asarray(beta_star)[None, :]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def support(beta: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    return np.nonzero(np.abs(np.asarray(beta)) > tol)[0]


def f1_score(beta_hat: np.ndarray, beta_star: np.ndarray, tol: float = 1e-8) -> float:
    sh, st = set(support(beta_hat, tol).tolist()), set(support(beta_star).tolist())
    if not sh or not st:
        return 0.0
    inter = len(sh & st)
    prec = inter / len(sh)
    rec = inter / len(st)
    return 0.0 if inter == 0 else 2 * prec * rec / (prec + rec)


def mean_f1(B: np.ndarray, beta_star: np.ndarray, tol: float = 1e-8) -> float:
    B = np.atleast_2d(np.asarray(B))
    return float(np.mean([f1_score(b, beta_star, tol) for b in B]))


def consensus_gap(B: np.ndarray) -> float:
    """Max pairwise distance between node estimates (0 at consensus)."""
    B = np.atleast_2d(np.asarray(B))
    mean = B.mean(axis=0, keepdims=True)
    return float(np.max(np.linalg.norm(B - mean, axis=1)))


def margin_accuracy(margins: np.ndarray, y: np.ndarray) -> float:
    """Accuracy of margin-based predictions with the tie rule
    ``margin >= 0 -> +1``.

    ``np.sign(margins) == y`` scores a zero margin as a third class —
    never equal to +/-1 labels — which under-reports accuracy for
    thresholded/degenerate fits (e.g. an all-zero B after Theorem-4
    thresholding would score 0.0 instead of the positive-class rate).
    Every accuracy reported by this repo decides ties the same way.
    """
    pred = np.where(np.asarray(margins) >= 0, 1.0, -1.0)
    return float(np.mean(pred == np.asarray(y)))


def accuracy(beta: np.ndarray, X: np.ndarray, y: np.ndarray) -> float:
    """Classification accuracy of sign(x' beta), ties to +1."""
    return margin_accuracy(np.asarray(X) @ np.asarray(beta), y)


def mean_support_size(B: np.ndarray, tol: float = 1e-8) -> float:
    B = np.atleast_2d(np.asarray(B))
    return float(np.mean([len(support(b, tol)) for b in B]))
