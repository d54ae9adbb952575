"""Tuning-parameter selection in torch: the modified BIC of Zhang et al.
(2016) (paper Section 4.1), k-fold cross-validation folds, the lambda grid,
and the wrappers over the path engine of ``repro_torch.core.path``.

    BIC(lambda) = N^-1 sum_l sum_i (1 - y_i x_i' b_l)_+
                  + sqrt(log N) * log p * mean_l |supp(b_l)| / N

Counterpart of ``repro.core.tuning``.  The NumPy functions
(``modified_bic``, ``kfold_masks``, ``lambda_grid``, ``select_lambda``,
``shared_lambda_grid``) are copies of the JAX package's, so the grid and
the folds are bit for bit the same on both sides; ``modified_bic_jnp``
keeps its JAX name, as the solver keeps the backend name ``"jnp"``.

``select_lambda_path`` and ``select_lambda_path_many`` keep the JAX
convention ``(best_lam, best_B, table, res)``.  ``engine="mesh"`` and
``"chunked"`` route the traversal through the (node, lam) mesh engine of
``repro_torch.core.decentral`` (the chunked one in its block schedule),
on ``mesh`` or on the caller's group (one rank outside a group).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import metrics

Tensor = torch.Tensor


def _host(a) -> np.ndarray:
    """A numpy view of an array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def modified_bic(X: np.ndarray, y: np.ndarray, B: np.ndarray,
                 tol: float = 1e-8) -> float:
    """X: (m, n, p), y: (m, n), B: (m, p).  NumPy reference."""
    X, y, B = map(np.asarray, (X, y, B))
    m, n, p = X.shape
    N = m * n
    margins = y * np.einsum("mnp,mp->mn", X, B)
    hinge = np.maximum(1.0 - margins, 0.0).sum() / N
    mean_supp = np.mean([(np.abs(b) > tol).sum() for b in B])
    return hinge + math.sqrt(math.log(N)) * math.log(p) * mean_supp / N


def modified_bic_jnp(X: Tensor, y: Tensor, B: Tensor,
                     tol: float = 1e-8) -> Tensor:
    """Torch port of ``modified_bic`` on the tensors' device.

    B is one solution (m, p), or a whole path (L, m, p): then X is read
    once for all L points (one batched product X (m, n, p) @ (m, p, L))
    and the result is the (L,) criterion.
    """
    m, n, p = X.shape
    N = m * n
    path = B if B.dim() == 3 else B[None]
    margins = y[:, :, None] * torch.bmm(X, path.permute(1, 2, 0))
    hinge = torch.sum(torch.clamp(1.0 - margins, min=0.0), dim=(0, 1)) / N
    mean_supp = torch.mean(
        torch.sum(torch.abs(path) > tol, dim=2).to(X.dtype), dim=1)
    crit = hinge + math.sqrt(math.log(N)) * math.log(p) * mean_supp / N
    return crit if B.dim() == 3 else crit[0]


def kfold_masks(m: int, n: int, k: int, seed: int = 0) -> np.ndarray:
    """(k, m, n) train masks in {0,1} for k-fold CV over each node's samples.

    Fold assignment is a per-node random permutation of ``range(n)`` taken
    mod k, so every fold holds out ~n/k samples *per node* (the network
    analogue of stratified folds: no node ever loses all its data, which
    would zero its local gradient).  mask==1 marks training rows; the
    validation rows of fold j are the complement.
    """
    if not 2 <= k <= n:
        raise ValueError(f"need 2 <= k <= n, got k={k}, n={n}")
    rng = np.random.default_rng(seed)
    fold_of = np.stack([rng.permutation(n) % k for _ in range(m)])  # (m, n)
    masks = np.ones((k, m, n), np.float32)
    for j in range(k):
        masks[j][fold_of == j] = 0.0
    return masks


def _lambda_max(X: np.ndarray, y: np.ndarray) -> float:
    """|X'y/N|_inf — the all-zero (hinge-subgradient) threshold."""
    X2 = np.asarray(X).reshape(-1, X.shape[-1])
    y2 = np.asarray(y).reshape(-1)
    return float(np.max(np.abs(X2.T @ y2)) / len(y2))


def _log_grid(lam_max: float, num: int, min_frac: float) -> np.ndarray:
    """The repo's one grid convention: log-spaced, *decreasing* from
    lam_max to lam_max * min_frac (the order warm continuation needs)."""
    return np.logspace(math.log10(lam_max), math.log10(lam_max * min_frac),
                       num)


def lambda_grid(X: np.ndarray, y: np.ndarray, num: int = 12,
                min_frac: float = 1e-3) -> np.ndarray:
    """Log-spaced grid below lambda_max = |X'y/N|_inf (all-zero threshold).

    Returned in *decreasing* order — the traversal order the warm-start
    continuation engine requires.
    """
    return _log_grid(_lambda_max(X, y), num, min_frac)


def select_lambda(fit_fn: Callable[[float], np.ndarray], X: np.ndarray,
                  y: np.ndarray, lams: Sequence[float]):
    """Cold-start reference loop: fit at each lambda on the host, return
    (best_lambda, best_B, table).  ``fit_fn`` may return a tensor on any
    device.  Prefer ``select_lambda_path`` for any grid larger than a few
    points.
    """
    best = (None, None, np.inf)
    table = []
    for lam in lams:
        B = _host(fit_fn(float(lam)))
        crit = modified_bic(X, y, B)
        table.append((float(lam), crit, metrics.mean_support_size(B)))
        if crit < best[2]:
            best = (float(lam), B, crit)
    return best[0], best[1], table


def select_lambda_path(X, y, W, cfg, lams: Optional[Sequence[float]] = None,
                       num: int = 12, mode: str = "warm", tol: float = 1e-6,
                       lam_weights=None, criterion: str = "bic",
                       cv_folds: int = 5, cv_seed: int = 0,
                       stop_rule: str = "kkt", engine: str = "dense",
                       mesh=None, schedule: str = "gather",
                       check_every: int = 4, *, rho=None, cv_rho=None,
                       device=None):
    """Grid selection through ``repro_torch.core.path``.

    Builds ``lambda_grid(X, y, num)`` when ``lams`` is omitted, runs the
    batched or warm-start traversal, scores it with the modified BIC
    (``criterion="bic"``) or k-fold cross-validation (``"cv"``), and
    returns the same (best_lam, best_B, table) triple as ``select_lambda``
    — best_B as numpy, table rows (lambda, criterion, mean support size) —
    plus the ``PathResult`` (tensors on the device) as a fourth element.
    ``rho`` (m,) and, under ``"cv"``, ``cv_rho`` (k, m) optionally fix the
    per-node step sizes of the full-data and of the fold fits; ``device``
    as in ``admm.decsvm_fit``.  ``engine="mesh"`` routes the traversal
    through the (node, lam) mesh engine (``decentral.decsvm_path_mesh``,
    on ``mesh`` with ``schedule``); ``engine="chunked"`` runs the same
    engine in its block schedule (any m, and ``W`` may be a
    ``graph.BlockTopology``).  The mesh engine checks its stop every 4
    rounds whatever ``check_every`` says, as JAX's does.
    """
    from repro_torch.core import path as path_mod  # local import: avoid cycle

    if lams is None:
        lams = lambda_grid(_host(X), _host(y), num=num)
    if engine in ("mesh", "chunked"):
        from repro_torch.core import decentral  # local import: avoid cycle
        if engine == "chunked":
            schedule = "block"
        else:
            W = _host(W)
        res = decentral.decsvm_path_mesh(
            X, y, W, lams, cfg, mesh=mesh, schedule=schedule, mode=mode,
            tol=tol, lam_weights=lam_weights, stop_rule=stop_rule,
            criterion=criterion, cv_folds=cv_folds, cv_seed=cv_seed,
            rho=rho, cv_rho=cv_rho, device=device)
    elif engine == "dense":
        res = path_mod.decsvm_path_select(
            X, y, W, lams, cfg, mode=mode, tol=tol, lam_weights=lam_weights,
            stop_rule=stop_rule, criterion=criterion, cv_folds=cv_folds,
            cv_seed=cv_seed, check_every=check_every, rho=rho,
            cv_rho=cv_rho, device=device)
    else:
        raise ValueError(
            f"engine {engine!r} not in ('dense', 'mesh', 'chunked')")
    table = [(float(l), float(c), metrics.mean_support_size(B))
             for l, c, B in zip(_host(res.lams), _host(res.criteria),
                                _host(res.path))]
    return float(res.best_lam), _host(res.best_B), table, res


def shared_lambda_grid(Xs: np.ndarray, ys: np.ndarray, num: int = 12,
                       min_frac: float = 1e-3) -> np.ndarray:
    """One grid for a stack of problems: lambda_max is the max of the
    per-problem all-zero thresholds, so the grid's top point (nearly)
    zeroes every problem in the bucket.  Xs: (B, m, n, p), ys: (B, m, n);
    decreasing, same convention as ``lambda_grid``.
    """
    Xs, ys = np.asarray(Xs), np.asarray(ys)
    lam_max = max(_lambda_max(Xb, yb) for Xb, yb in zip(Xs, ys))
    return _log_grid(lam_max, num, min_frac)


def select_lambda_path_many(Xs, ys, Ws, cfg,
                            lams: Optional[Sequence[float]] = None,
                            num: int = 12, mode: str = "warm",
                            tol: float = 1e-6, lam_weights=None,
                            criterion: str = "bic", cv_folds: int = 5,
                            cv_seed: int = 0, stop_rule: str = "kkt",
                            check_every: int = 4, *, rho=None, cv_rho=None,
                            device=None):
    """Problem-batched ``select_lambda_path``
    (``repro_torch.core.path.decsvm_path_select_many``).

    Xs: (B, m, n, p), ys: (B, m, n), Ws: (B, m, m).  All problems share
    one grid — ``lams`` explicitly, or ``shared_lambda_grid(num)``.
    ``rho`` (B, m) and ``cv_rho`` (B, k, m) optionally fix the step sizes.

    Returns (best_lams (B,), best_Bs (B, m, p), tables, res) — the first
    two as numpy — where ``tables[b]`` is the per-problem (lambda,
    criterion, support) table and ``res`` the batched ``PathResult``.  With
    ``repro_torch.spans`` on, the copies to the host and the tables are
    the span ``path.tables``.
    """
    from repro_torch.core import path as path_mod  # local import: avoid cycle

    if lams is None:
        lams = shared_lambda_grid(_host(Xs), _host(ys), num=num)
    res = path_mod.decsvm_path_select_many(
        Xs, ys, Ws, lams, cfg, mode=mode, tol=tol, lam_weights=lam_weights,
        stop_rule=stop_rule, criterion=criterion, cv_folds=cv_folds,
        cv_seed=cv_seed, check_every=check_every, rho=rho, cv_rho=cv_rho,
        device=device)
    with spans.span("path.tables"):
        lams_np = _host(res.lams)          # (B, L)
        crits_np = _host(res.criteria)     # (B, L)
        path_np = _host(res.path)          # (B, L, m, p)
        tables = [[(float(l), float(c), metrics.mean_support_size(B))
                   for l, c, B in zip(lams_np[b], crits_np[b], path_np[b])]
                  for b in range(path_np.shape[0])]
        return _host(res.best_lam), _host(res.best_B), tables, res
