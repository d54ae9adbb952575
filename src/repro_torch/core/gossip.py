"""Gossip primitives for decentralized scalar aggregation, in torch.

Paper Section 4.1: "the use of a gossip protocol allows for efficient
broadcasting of scalar values (loss and estimated sparsity) across the
network" — used to evaluate the modified BIC without a fusion center.
Metropolis-weight gossip converges geometrically to the network average at
rate |lambda_2(M)| (Yadav & Salapaka 2007).

Counterpart of ``repro.core.gossip``: ``metropolis_weights_jnp`` keeps its
JAX name (as ``tuning.modified_bic_jnp`` does); ``gossip_average``'s
``lax.scan`` is a loop of ``M @ v`` on the values' device;
``gossip_rounds_needed`` is the NumPy function, copied.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.admm import as_f32, resolve_device
from repro_torch.core.graph import metropolis_weights

Tensor = torch.Tensor


def metropolis_weights_jnp(W: Tensor) -> Tensor:
    """Metropolis–Hastings mixing matrix on W's device: M_ij = W_ij /
    (1 + max(deg_i, deg_j)) off-diagonal, rows summing to 1 (the tensor
    form of ``graph.metropolis_weights``)."""
    W = torch.as_tensor(W)
    deg = torch.sum(W, dim=1)
    pair_deg = torch.maximum(deg[:, None], deg[None, :])
    M = W / (1.0 + pair_deg)
    return M + torch.diag(1.0 - torch.sum(M, dim=1))


def gossip_average(values: Tensor, W, rounds: int = 50) -> Tensor:
    """values: (m, ...) per-node scalars/vectors -> per-node estimates of the
    network average after ``rounds`` one-hop gossip exchanges, on the
    values' device."""
    M = metropolis_weights_jnp(as_f32(W, values.device))
    flat = values.reshape(values.shape[0], -1)
    M = M.to(flat.dtype)
    for _ in range(rounds):
        flat = M @ flat
    return flat.reshape(values.shape)


def gossip_rounds_needed(W: np.ndarray, tol: float = 1e-6) -> int:
    """Rounds for worst-case contraction below tol: ceil(log tol / log s2)."""
    M = metropolis_weights(np.asarray(W)).astype(np.float64)
    eig = np.sort(np.abs(np.linalg.eigvals(M)))
    s2 = float(eig[-2]) if len(eig) > 1 else 0.0
    if s2 <= 0.0 or s2 >= 1.0:
        return 1 if s2 <= 0 else 10_000
    return int(math.ceil(math.log(tol) / math.log(s2)))


def decentralized_bic(X, y, B, W, rounds: int = 60, tol: float = 1e-8, *,
                      device=None) -> Tuple[Tensor, float]:
    """Modified BIC evaluated WITHOUT a fusion center.

    Each node contributes its local hinge total and support size; two gossip
    scalars propagate the averages; every node then forms the same BIC value
    (returned per node, as an (m,) tensor, plus the exact centralized value
    for reference).  ``device`` as in ``admm.decsvm_fit``.
    """
    dev = resolve_device(X, device)
    X, y, B = as_f32(X, dev), as_f32(y, dev), as_f32(B, dev)
    m, n, p = X.shape
    N = m * n
    margins = y * torch.bmm(X, B[..., None])[..., 0]
    local_hinge = torch.sum(torch.clamp(1.0 - margins, min=0.0), dim=1)
    local_supp = torch.sum(torch.abs(B) > tol, dim=1).to(torch.float32)
    scalars = torch.stack([local_hinge, local_supp], dim=1)         # (m, 2)
    avg = gossip_average(scalars, W, rounds)                        # (m, 2)
    hinge_term = avg[:, 0] * m / N        # avg*m = network sum
    supp_term = avg[:, 1]                 # mean support
    pen = math.sqrt(math.log(N)) * math.log(p - 1)
    bic_per_node = hinge_term + pen * supp_term / N
    exact = float(torch.sum(local_hinge) / N
                  + pen * torch.mean(local_supp) / N)
    return bic_per_node, exact
