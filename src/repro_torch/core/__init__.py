"""deCSVM core in torch: the paper's contribution, Algorithm 1, with the
lambda path, tuning, the baselines, the folded-concave penalties, the
E1-E7 sanitizer, gossip, and the decentralized engines across ranks.

``repro_torch.core.solver`` is the single home of the Algorithm-1 update;
every fitting surface exported here is a thin driver over it.
``decentral`` runs JAX's sharded, chunked and (node, lam) mesh engines
over the ranks of a ``torch.distributed`` group (``launch.ranks``), and
at one rank outside a group.
"""
from repro_torch.core import (baselines, decentral, gossip, graph, losses,
                              metrics, path, penalties, sanitize, simulate,
                              solver, tuning)
from repro_torch.core.solver import Problem, SolverState, kkt_residual
from repro_torch.core.admm import (ADMMConfig, decsvm_fit, soft_threshold,
                                   compute_rho, objective,
                                   hard_threshold_final)
from repro_torch.core.losses import (smoothed_hinge_loss, smoothed_hinge_grad,
                                     get_kernel, hinge, KERNELS,
                                     default_bandwidth)
from repro_torch.core.simulate import SimConfig, generate, true_beta
from repro_torch.core.admm_adaptive import decsvm_fit_tol, decsvm_fit_uneven
from repro_torch.core.path import (PathResult, decsvm_path_batched,
                                   decsvm_path_select, decsvm_path_warm)
from repro_torch.core.penalties import decsvm_fit_lla

__all__ = [
    "solver", "Problem", "SolverState", "kkt_residual",
    "ADMMConfig", "decsvm_fit", "soft_threshold", "compute_rho", "objective",
    "hard_threshold_final", "smoothed_hinge_loss", "smoothed_hinge_grad",
    "get_kernel", "hinge", "KERNELS", "default_bandwidth", "SimConfig",
    "generate", "true_beta", "graph", "losses", "metrics", "simulate",
    "path", "tuning", "baselines", "penalties", "sanitize", "gossip",
    "decentral",
    "decsvm_fit_tol", "decsvm_fit_uneven", "decsvm_fit_lla", "PathResult",
    "decsvm_path_batched", "decsvm_path_warm", "decsvm_path_select",
]
