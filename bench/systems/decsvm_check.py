"""The comparison that decides ``correct`` in a deCSVM cell.

Every answer that the window delivered is compared with the plain
reference (``bench/reference/<reference>.py``), run once for each dataset
the answers used, after the window has closed.  The numbers compared:

- ``est_gap``: the delivered estimate B (m, p) against the reference's
  estimate at the delivered λ, max |B - B_ref| / max |B_ref|, the widest
  over the answers.  A λ counts as selected rightly when the reference's
  BIC there exceeds its least by no more than a BIC within the limits
  below can err at the two points (a tie to rounding); a λ outside that
  also adds the distance of the reference's estimate there from its own
  tuned one, so a wrong selection reads as far as it lies.
- ``hinge_gap``: the delivered BIC table's hinge part (each row's BIC
  less its support term, from the row's own mean support size) against
  the reference's, the widest relative gap over the answers and the grid
  points.  The support term is left to ``supp_gap``: a coordinate that
  rounding puts just on either side of the soft threshold moves the BIC
  by a whole step, the same on any sound run.
- ``supp_gap``: the delivered table's mean support size a node against
  the reference's, the widest gap (in coordinates) over the answers and
  the grid points.
- ``grid_gap``: answers whose table does not hold the grid, in fp32, as
  given, or whose λ is not a grid point (exact: limit 0).
- ``failed``: requests due in the window that raised or never came
  (exact: limit 0).
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from systems import decsvm_inputs as inputs


def _gap(a: np.ndarray, ref: np.ndarray) -> float:
    scale = float(np.max(np.abs(ref)))
    diff = float(np.max(np.abs(np.asarray(a, np.float64) - ref)))
    # an all-zero reference estimate: any entry off zero reads as huge
    return diff / max(scale, 1e-30)


def references(config: dict, pool: inputs.Pool, used: Sequence[int],
               tf32: bool = False, budget_bytes: int = 1 << 30
               ) -> Dict[int, tuple]:
    """The reference's (path (L, m, p), BIC (L,), mean support size a node
    (L,)) as fp64 numpy for each
    dataset in ``used``, in blocks of datasets that fit ``budget_bytes``."""
    ref = importlib.import_module(f"reference.{config['reference']}")
    settings = dict(h=inputs.bandwidth(config), tau=config["tau"],
                    lam0=config["lam0"], rho_safety=config["rho_safety"],
                    max_iter=config["max_iter"], kernel=config["kernel"])
    used = sorted(set(used))
    block = inputs.fits_in(budget_bytes, config)
    grid = inputs.grid_fp32(pool.grid)
    out = {}
    for lo in range(0, len(used), block):
        idx = used[lo:lo + block]
        dev = pool.X[idx[0]].device
        X = torch.stack([pool.X[i] for i in idx])
        y = torch.stack([pool.y[i] for i in idx])
        W = torch.stack([torch.as_tensor(pool.W[i], device=dev)
                         for i in idx])
        path, bic, supp = (t.double().cpu().numpy() for t in
                           ref.tuned_paths(X, y, W, grid, settings, tf32=tf32))
        for k, i in enumerate(idx):
            out[i] = (path[k], bic[k], supp[k])
        del X, y, W
    return out


def answer_of(result, pool_index: int) -> dict:
    """What the comparison reads of a ``FitResult``."""
    return dict(pool=pool_index, best_lam=float(result.best_lam),
                B=np.asarray(result.B),
                table=[(float(l), float(c), float(s))
                       for l, c, s in result.table])


def reference_answer(path: np.ndarray, bic: np.ndarray, supp: np.ndarray,
                     grid, pool_index: int) -> dict:
    """The answer a reference run delivers (the control's)."""
    i = int(np.argmin(bic))
    g = inputs.grid_fp32(grid)
    return dict(pool=pool_index, best_lam=float(g[i]), B=path[i],
                table=list(zip(map(float, g), map(float, bic),
                               map(float, supp))))


def numbers(answers: List[dict], refs: Dict[int, tuple], grid, config: dict,
            limits: dict, failed: int) -> Dict[str, float]:
    g = inputs.grid_fp32(grid).astype(np.float64)
    step = support_step(config)
    est, hinge_gap, supp_gap, grid_gap = 0.0, 0.0, 0.0, 0
    for a in answers:
        path, bic, supp = refs[a["pool"]]
        rows = np.asarray(a["table"], np.float64).reshape(-1, 3)
        where = np.nonzero(g == np.float32(a["best_lam"]))[0]
        if rows.shape[0] != len(g) or not np.array_equal(rows[:, 0], g) \
                or len(where) != 1:
            grid_gap += 1
            continue
        hinge, hinge_ref = rows[:, 1] - step * rows[:, 2], bic - step * supp
        hinge_gap = max(hinge_gap, float(np.max(np.abs(hinge - hinge_ref)
                                                / np.abs(hinge_ref))))
        supp_gap = max(supp_gap, float(np.max(np.abs(rows[:, 2] - supp))))
        i, j = int(where[0]), int(np.argmin(bic))
        gap = _gap(a["B"], path[i])
        # how far a BIC within the limits can lie from the reference's
        err = limits["hinge_gap"] * np.abs(hinge_ref) \
            + step * limits["supp_gap"]
        if bic[i] - bic[j] > err[i] + err[j]:
            gap = max(gap, _gap(path[i], path[j]))
        est = max(est, gap)
    return {"est_gap": est, "hinge_gap": hinge_gap, "supp_gap": supp_gap,
            "grid_gap": float(grid_gap), "failed": float(failed)}


def support_step(config: dict) -> float:
    """The modified BIC's weight of one unit of mean support size:
    sqrt(log N) log p / N, with p the columns of X."""
    N = config["m"] * config["n"]
    return math.sqrt(math.log(N)) * math.log(config["p"] + 1) / N


def limits_of(limits: dict) -> Dict[str, float]:
    return {"est_gap": limits["est_gap"], "hinge_gap": limits["hinge_gap"],
            "supp_gap": limits["supp_gap"], "grid_gap": 0.0, "failed": 0.0}


def correct(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in limits)
