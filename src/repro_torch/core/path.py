"""Regularization-path engine in torch: Algorithm 1 over a whole lambda
grid on the card (paper Section 4.1 tuning).

Counterpart of ``repro.core.path``.  Every traversal drives the unified
step of ``repro_torch.core.solver``; this module adds the grid loops and
the selection criteria:

- ``decsvm_path_batched``: every grid point cold-started for
  ``cfg.max_iter`` rounds.  JAX ``vmap``s the fit over lambda; here the L
  points are a loop over ``solver.run_fixed`` on ONE problem (``rho`` and
  the copy of X are made once a path), so under a megakernel backend the
  path is L launches of the round kernel, one per point (the kernel has
  no lambda axis).
- ``decsvm_path_warm``: continuation over *decreasing* lambda, each fit
  seeded with the previous solution (duals restart at zero) and stopped
  per point by ``solver.run_tol`` on the KKT residual (or the progress
  rule); under a megakernel backend each check block is one fused
  k-round + KKT launch.
- ``decsvm_path_cv``: k-fold cross-validation — each fold's masked
  problem fitted at every grid point (batched semantics), scored by the
  held-out hinge loss.  Masked fits take the reference rounds on every
  backend: the kernels have no mask operand.

The grid is rounded to fp32 once (JAX casts it to X's dtype) and each
point reaches the step as a Python float, so no step waits on the card
for its lambda.  ``decsvm_path_select`` scores the path with the modified
BIC (``tuning.modified_bic_jnp``, one batched product over the caller's
fp32 X for all L points) or CV and returns a ``PathResult`` of tensors on
the device.  ``decsvm_fit_many`` and ``decsvm_path_select_many`` loop over
a stack of same-shape problems (each with its own rho and omega) sharing
one grid and one CV mask set; their results carry a leading (B,) axis.

Every entry point takes ``rho=`` to fix the per-node step sizes, as
``admm.decsvm_fit`` does: (m,) for the full-data fits, and ``cv_rho=``
(k, m), one row per fold, for the fold fits under ``criterion="cv"``
(``decsvm_path_cv`` takes its (k, m) as ``rho``); the ``_many`` entry
points take them with a leading (B,) axis.  ``device`` defaults to X's
device for a tensor, else CUDA (``admm.resolve_device``).

With ``repro_torch.spans`` on, each problem of
``decsvm_path_select_many`` (``path.problem``, with its index ``b``),
each cold-started grid point (``path.point``) and the BIC scoring
(``path.score``) is recorded as a span.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import sanitize, solver
from repro_torch.core.admm import ADMMConfig, as_f32, resolve_device
from repro_torch.core.tuning import _host, kfold_masks, modified_bic_jnp

Tensor = torch.Tensor


class PathResult(NamedTuple):
    best_lam: Tensor   # ()      grid point minimizing the criterion
    best_B: Tensor     # (m, p)  node estimates at best_lam
    lams: Tensor       # (L,)    the grid, as traversed (fp32)
    path: Tensor       # (L, m, p) solutions at every grid point
    criteria: Tensor   # (L,)    selection criterion (modified BIC / CV hinge)
    iters: Tensor      # (L,)    ADMM rounds actually run per grid point


def _grid(lams) -> np.ndarray:
    """The grid as fp32, the precision JAX traverses it in."""
    return np.asarray(_host(lams), np.float32).reshape(-1)


def _opt(a, dev) -> Optional[Tensor]:
    return None if a is None else as_f32(a, dev)


def _on_device(X, y, W, device):
    dev = resolve_device(X, device)
    return dev, as_f32(X, dev), as_f32(y, dev), as_f32(W, dev)


def _problem(X, y, W, cfg, rho, mask=None):
    """One problem and its dense step: rho (``compute_rho``, or the given
    one) and the backend's copy of X are made here, once."""
    prob = solver.make_problem(X, y, W, cfg, mask=mask, rho=rho)
    return prob, solver.make_step(cfg, lambda B: W @ B, W=W)


def _cold_path(prob, step, grid, cfg, lam_weights) -> Tensor:
    """Every grid point cold-started for ``cfg.max_iter`` rounds."""
    points = []
    for lam in grid:
        with spans.span("path.point"):
            points.append(solver.run_fixed(step, prob, float(lam),
                                           lam_weights,
                                           num_iters=cfg.max_iter).B)
    return torch.stack(points)


def _batched(X, y, W, grid, cfg, lam_weights, rho) -> Tensor:
    prob, step = _problem(X, y, W, cfg, rho)
    return _cold_path(prob, step, grid, cfg, lam_weights)


def _warm(X, y, W, grid, cfg, tol, lam_weights, stop_rule, check_every,
          rho):
    prob, step = _problem(X, y, W, cfg, rho)
    residual_fn = (solver.kkt_residual_fn(cfg) if stop_rule == "kkt"
                   else None)
    B, path, iters = None, [], []
    for lam in grid:
        final = solver.run_tol(step, prob, float(lam), lam_weights,
                               max_iter=cfg.max_iter, tol=tol,
                               state=solver.init_state(prob, B0=B),
                               residual_fn=residual_fn,
                               check_every=check_every)
        B = final.B
        path.append(B)
        iters.append(final.t)
    return torch.stack(path), torch.stack(iters)


def _cv(X, y, W, grid, cfg, masks, lam_weights, rho) -> Tensor:
    scores = []
    for j, mask in enumerate(masks):
        prob, step = _problem(X, y, W, cfg, None if rho is None else rho[j],
                              mask=mask)
        path = _cold_path(prob, step, grid, cfg, lam_weights)
        val = 1.0 - mask                                    # held-out rows
        margins = torch.bmm(X, path.permute(1, 2, 0)) * y[:, :, None]
        hinge = torch.clamp(1.0 - margins, min=0.0) * val[:, :, None]
        scores.append(torch.sum(hinge, dim=(0, 1))
                      / torch.clamp(torch.sum(val), min=1.0))
    return torch.mean(torch.stack(scores), dim=0)           # (L,)


def decsvm_path_batched(X, y, W, lams, cfg: ADMMConfig, lam_weights=None, *,
                        rho=None, device=None) -> Tensor:
    """Fit every lambda cold-started for a fixed number of rounds.

    X: (m, n, p), y: (m, n), W: (m, m), lams: (L,).
    Returns the path B: (L, m, p).  cfg.lam is ignored.
    """
    sanitize.reject_unsupported(cfg, "decsvm_path_batched")
    dev, X, y, W = _on_device(X, y, W, device)
    return _batched(X, y, W, _grid(lams), cfg, _opt(lam_weights, dev),
                    _opt(rho, dev))


def decsvm_path_warm(X, y, W, lams, cfg: ADMMConfig, tol: float = 1e-6,
                     lam_weights=None, stop_rule: str = "kkt",
                     check_every: int = 4, *, rho=None, device=None):
    """Sequential continuation over *decreasing* lambda with warm starts.

    Each grid point seeds B from the previous solution (duals restart at
    zero) and early-stops once the stop statistic <= tol: the
    KKT/duality-gap residual by default (``stop_rule="kkt"``), or the
    iterate-progress rule max|B_t - B_{t-1}| (``"progress"``), measured
    every ``check_every``-th round.
    Returns (path (L, m, p), iters (L,) int32).  cfg.lam is ignored.
    """
    if stop_rule not in ("kkt", "progress"):
        raise ValueError(f"stop_rule {stop_rule!r} not in ('kkt', 'progress')")
    sanitize.reject_unsupported(cfg, "decsvm_path_warm")
    dev, X, y, W = _on_device(X, y, W, device)
    return _warm(X, y, W, _grid(lams), cfg, tol, _opt(lam_weights, dev),
                 stop_rule, check_every, _opt(rho, dev))


def score_path(X: Tensor, y: Tensor, path: Tensor) -> Tensor:
    """Modified BIC at every path point, on X's device.  path: (L, m, p);
    X is read once for all L points."""
    return modified_bic_jnp(X, y, path)


def decsvm_path_cv(X, y, W, lams, cfg: ADMMConfig, masks, lam_weights=None,
                   *, rho=None, device=None) -> Tensor:
    """k-fold cross-validation scores of the grid.

    masks: (k, m, n) train masks in {0,1} (``tuning.kfold_masks``); fold j
    fits on mask rows (cold-started, ``cfg.max_iter`` rounds per point)
    and scores the held-out hinge loss on the complement.  ``rho``: (k, m),
    one row per fold.  Returns cv (L,): mean held-out hinge per grid point
    — lower is better.
    """
    sanitize.reject_unsupported(cfg, "decsvm_path_cv")
    dev, X, y, W = _on_device(X, y, W, device)
    return _cv(X, y, W, _grid(lams), cfg, as_f32(masks, dev),
               _opt(lam_weights, dev), _opt(rho, dev))


def _path_select(X, y, W, grid, cfg, mode, tol, lam_weights, stop_rule,
                 cv_masks, check_every, rho, cv_rho) -> PathResult:
    if mode == "batched":
        path = _batched(X, y, W, grid, cfg, lam_weights, rho)
        iters = torch.full((len(grid),), cfg.max_iter, dtype=torch.int32,
                           device=X.device)
    else:
        path, iters = _warm(X, y, W, grid, cfg, tol, lam_weights, stop_rule,
                            check_every, rho)
    if cv_masks is None:
        with spans.span("path.score"):
            crits = score_path(X, y, path)
    else:
        crits = _cv(X, y, W, grid, cfg, cv_masks, lam_weights, cv_rho)
    i = torch.argmin(crits)
    lams = torch.as_tensor(grid, device=X.device)
    return PathResult(lams[i], path[i], lams, path, crits, iters)


def _validate_select(mode, stop_rule, criterion, cfg=None):
    if cfg is not None:
        sanitize.reject_unsupported(cfg, "decsvm_path_select")
    if mode not in ("warm", "batched"):
        raise ValueError(f"mode {mode!r} not in ('warm', 'batched')")
    if stop_rule not in ("kkt", "progress"):
        raise ValueError(f"stop_rule {stop_rule!r} not in ('kkt', 'progress')")
    if criterion not in ("bic", "cv"):
        raise ValueError(f"criterion {criterion!r} not in ('bic', 'cv')")


def _cv_masks_for(shape_m, shape_n, criterion, cv_folds, cv_seed, device):
    if criterion != "cv":
        return None
    return as_f32(kfold_masks(shape_m, shape_n, cv_folds, seed=cv_seed),
                  device)


def decsvm_path_select(X, y, W, lams: Tensor | Sequence[float],
                       cfg: ADMMConfig, mode: str = "warm", tol: float = 1e-6,
                       lam_weights=None, stop_rule: str = "kkt",
                       criterion: str = "bic", cv_folds: int = 5,
                       cv_seed: int = 0, check_every: int = 4, *, rho=None,
                       cv_rho=None, device=None) -> PathResult:
    """Traverse the grid and pick lambda.

    mode: "warm" (continuation + early stop, fewest rounds) or "batched"
    (cold-start, fixed rounds, matches the sequential reference).
    criterion: "bic" (modified BIC of Zhang et al. 2016) or "cv" (k-fold
    held-out hinge, ``cv_folds`` folds).  The path, its criteria and the
    argmin stay on the device.
    """
    _validate_select(mode, stop_rule, criterion, cfg)
    dev, X, y, W = _on_device(X, y, W, device)
    cv_masks = _cv_masks_for(X.shape[0], X.shape[1], criterion, cv_folds,
                             cv_seed, dev)
    return _path_select(X, y, W, _grid(lams), cfg, mode, tol,
                        _opt(lam_weights, dev), stop_rule, cv_masks,
                        check_every, _opt(rho, dev), _opt(cv_rho, dev))


def _stack_of(Xs, ys, Ws, device):
    dev = resolve_device(Xs, device)
    Xs, ys, Ws = as_f32(Xs, dev), as_f32(ys, dev), as_f32(Ws, dev)
    if Xs.dim() != 4:
        raise ValueError(f"Xs must be (B, m, n, p), got shape "
                         f"{tuple(Xs.shape)}")
    return dev, Xs, ys, Ws


def _row(a: Optional[Tensor], b: int) -> Optional[Tensor]:
    return None if a is None else a[b]


def decsvm_fit_many(Xs, ys, Ws, lams, cfg: ADMMConfig, lam_weights=None, *,
                    rho=None, device=None) -> Tensor:
    """Fit a stack of same-shape problems, each at its own lambda.

    Xs: (B, m, n, p), ys: (B, m, n), Ws: (B, m, m), lams: (B,) per-problem
    l1 levels, lam_weights: optional (B, p) per-coordinate multipliers,
    rho: optional (B, m).  Each problem gets its own rho/omega
    (``solver.make_problem``) and ``cfg.max_iter`` cold-started rounds —
    one round-kernel launch per problem under a megakernel backend.
    Returns B: (B, m, p); cfg.lam is ignored.
    """
    sanitize.reject_unsupported(cfg, "decsvm_fit_many")
    dev, Xs, ys, Ws = _stack_of(Xs, ys, Ws, device)
    grid, lw, rho = _grid(lams), _opt(lam_weights, dev), _opt(rho, dev)
    out = []
    for b in range(Xs.shape[0]):
        prob, step = _problem(Xs[b], ys[b], Ws[b], cfg, _row(rho, b))
        out.append(solver.run_fixed(step, prob, float(grid[b]), _row(lw, b),
                                    num_iters=cfg.max_iter).B)
    return torch.stack(out)


def decsvm_path_select_many(Xs, ys, Ws, lams: Tensor | Sequence[float],
                            cfg: ADMMConfig, mode: str = "warm",
                            tol: float = 1e-6, lam_weights=None,
                            stop_rule: str = "kkt", criterion: str = "bic",
                            cv_folds: int = 5, cv_seed: int = 0,
                            check_every: int = 4, *, rho=None, cv_rho=None,
                            device=None) -> PathResult:
    """Problem-batched ``decsvm_path_select``.

    Xs: (B, m, n, p), ys: (B, m, n), Ws: (B, m, m) stack B same-shape
    problems; ``lams`` (L,) is the grid shared by the bucket, and CV folds
    reuse one mask set (same (m, n, cv_folds, cv_seed) => the serial
    path's masks).  Each problem is traversed, scored and selected as
    ``decsvm_path_select`` would, with its own rho/omega and, in warm
    mode, its own early stops.

    Returns a ``PathResult`` whose fields carry a leading (B,) axis:
    best_lam (B,), best_B (B, m, p), lams (B, L), path (B, L, m, p),
    criteria (B, L), iters (B, L).
    """
    _validate_select(mode, stop_rule, criterion, cfg)
    dev, Xs, ys, Ws = _stack_of(Xs, ys, Ws, device)
    cv_masks = _cv_masks_for(Xs.shape[1], Xs.shape[2], criterion, cv_folds,
                             cv_seed, dev)
    grid, lw = _grid(lams), _opt(lam_weights, dev)
    rho, cv_rho = _opt(rho, dev), _opt(cv_rho, dev)
    results = []
    for b in range(Xs.shape[0]):
        with spans.span("path.problem", b=b):
            results.append(_path_select(
                Xs[b], ys[b], Ws[b], grid, cfg, mode, tol, lw, stop_rule,
                cv_masks, check_every, _row(rho, b), _row(cv_rho, b)))
    return PathResult(*(torch.stack(field) for field in zip(*results)))
