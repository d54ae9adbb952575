"""deCSVM core in torch: the paper's contribution, Algorithm 1.

``repro_torch.core.solver`` is the single home of the Algorithm-1 update;
every fitting surface exported here is a thin driver over it.  This is
the first slice of the port of ``repro.core``: the lambda path, tuning,
baselines, penalties, gossip, sanitize and the sharded engines are not
here yet.
"""
from repro_torch.core import graph, losses, metrics, simulate, solver
from repro_torch.core.solver import Problem, SolverState, kkt_residual
from repro_torch.core.admm import (ADMMConfig, decsvm_fit, soft_threshold,
                                   compute_rho, objective,
                                   hard_threshold_final)
from repro_torch.core.losses import (smoothed_hinge_loss, smoothed_hinge_grad,
                                     get_kernel, hinge, KERNELS,
                                     default_bandwidth)
from repro_torch.core.simulate import SimConfig, generate, true_beta
from repro_torch.core.admm_adaptive import decsvm_fit_tol, decsvm_fit_uneven

__all__ = [
    "solver", "Problem", "SolverState", "kkt_residual",
    "ADMMConfig", "decsvm_fit", "soft_threshold", "compute_rho", "objective",
    "hard_threshold_final", "smoothed_hinge_loss", "smoothed_hinge_grad",
    "get_kernel", "hinge", "KERNELS", "default_bandwidth", "SimConfig",
    "generate", "true_beta", "graph", "losses", "metrics", "simulate",
    "decsvm_fit_tol", "decsvm_fit_uneven",
]
