"""A deCSVM cell's inputs, made from ``--seed`` on the card: the pool of
datasets with their networks and the configuration's shared λ grid.

The same seed gives the same inputs.  Every seed gives the same amount of
work: the pool's size, the grid's length and the rounds are fixed by the
configuration and the mix (which input each request takes, and an open
loop's arrivals, are the loops' own: ``harness.traffic``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from frozen import data


@dataclasses.dataclass(frozen=True)
class Sim:
    """The §4.1 law's sizes (the fields ``frozen.data`` reads)."""
    p: int
    s: int
    mu: float
    rho: float
    p_flip: float
    m: int
    n: int


@dataclasses.dataclass
class Pool:
    X: List[torch.Tensor]       # (m, n, p + 1) fp32 each, on the card
    y: List[torch.Tensor]       # (m, n)
    W: List[np.ndarray]         # (m, m) adjacency of each dataset's network
    grid: np.ndarray            # (L,) decreasing, shared by every request


def sim_of(config: dict) -> Sim:
    return Sim(p=config["p"], s=config["s"], mu=config["mu"],
               rho=config["ar_rho"], p_flip=config["p_flip"],
               m=config["m"], n=config["n"])


def lambda_max(X: torch.Tensor, y: torch.Tensor) -> float:
    """|X'y / N|_inf, the all-zero threshold, in fp64."""
    N = y.numel()
    Xd = X.reshape(N, -1).double()
    return float(torch.max(torch.abs(Xd.T @ y.reshape(N).double())) / N)


def make_pool(config: dict, traffic: dict, seed: int, device) -> Pool:
    size = int(traffic["pool"])
    Xs, ys = data.draw_pool(sim_of(config), seed, size, device)
    Ws = [data.erdos_renyi(config["m"], config["p_connect"], seed=s)
          for s in data.dataset_seeds(seed, size, stream=1)]
    lam_max = max(lambda_max(X, y) for X, y in zip(Xs, ys))
    grid = data.log_grid(lam_max, config["grid_points"],
                         config["grid_min_frac"])
    return Pool(Xs, ys, Ws, grid)


def bandwidth(config: dict) -> float:
    return data.default_bandwidth(config["m"] * config["n"], config["p"])


def grid_fp32(grid) -> np.ndarray:
    return np.asarray(grid, np.float32).reshape(-1)


def fits_in(budget_bytes: int, config: dict) -> int:
    """How many datasets of the configuration fit ``budget_bytes``."""
    one = config["m"] * config["n"] * (config["p"] + 1) * 4
    return max(1, math.floor(budget_bytes / one))
