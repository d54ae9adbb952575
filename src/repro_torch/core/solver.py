"""The single home of Algorithm 1 in the port: one state tuple, one
per-node update, one ``(lam, lam_weights)`` step, pluggable backends.

Counterpart of ``repro.core.solver``.  The dense drivers of this package
(``admm.decsvm_fit``, ``admm_adaptive.decsvm_fit_tol`` /
``decsvm_fit_uneven``) and the kernels' plain versions are thin drivers
over this module; the update math lives in ``local_update`` and the
``soft_threshold(omega * z, ...)`` line inside it.

JAX's ``vmap`` over nodes is a leading ``m`` dimension written out;
``lax.scan`` / ``while_loop`` are Python loops (the round kernel takes the
hot loop under the megakernel backends).  Every function runs on the
device of the tensors it is given.

Update (per node l, with deg_l = |N(l)|):
    grad_l = (1/n) sum_i L_h'(y_i x_i' b_l) y_i x_i
    z_l    = rho_l b_l - grad_l - p_l + tau * (deg_l * b_l + (W B)_l)
    b+_l   = S_{lam * w_l}( w_l * z_l ),   w_l = 1/(2 tau deg_l + rho_l + lam0)
    p+_l   = p_l + tau * (deg_l * b+_l - (W B+)_l)

The collective points of the sharded engines (``run_tol``'s agreed stop
flag, the node means and maxes of ``kkt_residual``) go through
``repro_torch.launch.mesh.collective``: the identity at one rank, a
``torch.distributed`` reduction over the mesh line's ranks otherwise.
Every rank of a line runs the same collectives in the same order: the
stop flag is agreed before the host reads it, and held rounds still run
their neighbour exchanges.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import losses
from repro_torch.launch.mesh import collective

Tensor = torch.Tensor


# declint: disable=R1 the port's one home of the prox; its plain kernel versions call it
def soft_threshold(v: Tensor, t) -> Tensor:
    """Coordinate-wise soft-thresholding S_t(v)."""
    # declint: disable=R1 the port's one home of the prox (see the def above)
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def _power_start(n: int, p: int) -> Tensor:
    """Power-iteration start vector, seeded from the operand shape.

    A CPU ``torch.Generator`` seeded with ``n * 1000003 + p`` (the JAX
    package seeds ``jax.random.PRNGKey`` the same way; the two generators
    draw different numbers, so rho agrees only to the power iteration's
    convergence, not bit for bit).  Drawn on the CPU so that every device
    starts from the same vector.
    """
    gen = torch.Generator(device="cpu").manual_seed(n * 1000003 + p)
    return torch.randn(p, generator=gen, dtype=torch.float32)


def power_iteration_lmax(X: Tensor, iters: int = 50) -> Tensor:
    """Largest eigenvalue of X'X/n per node, matrix-free.

    X is (n, p) or (m, n, p); returns a scalar or an (m,) tensor.  The
    normalization is guarded so that an all-zero node block yields
    lmax = 0 instead of NaN.
    """
    single = X.dim() == 2
    Xb = X[None] if single else X
    m, n, p = Xb.shape
    v = _power_start(n, p).to(device=X.device, dtype=X.dtype)
    v = (v / torch.linalg.vector_norm(v)).expand(m, p).contiguous()

    def apply(v):
        return torch.bmm(Xb.transpose(1, 2),
                         torch.bmm(Xb, v[..., None]))[..., 0] / n

    for _ in range(iters):
        w = apply(v)
        nrm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        safe = torch.where(nrm > 0.0, nrm, torch.ones_like(nrm))
        v = torch.where(nrm > 0.0, w / safe, v)
    w = apply(v)
    vv = torch.sum(v * v, dim=1)
    lmax = torch.where(vv > 0.0,
                       torch.sum(v * w, dim=1)
                       / torch.where(vv > 0.0, vv, torch.ones_like(vv)),
                       torch.zeros_like(vv))
    return lmax[0] if single else lmax


def compute_rho(X: Tensor, h: float, kernel: str, safety: float = 1.05,
                mask: Optional[Tensor] = None) -> Tensor:
    """rho_l >= c_h * Lmax(X_l'X_l/n_l) per node.  X: (m, n, p).

    With a sample ``mask`` (m, n), masked rows are zeroed and n_l is the
    per-node mask sum (the uneven-n extension of Section 2.1).
    """
    c_h = losses.get_kernel(kernel).lipschitz(h)
    if mask is None:
        lmax = power_iteration_lmax(X)
    else:
        Xm = X * mask[..., None]
        lmax = power_iteration_lmax(Xm) * X.shape[1] / torch.clamp(
            torch.sum(mask, dim=1), min=1.0)
    return safety * c_h * lmax


class SolverState(NamedTuple):
    """Algorithm-1 iterate, shared by every driver of the port."""
    B: Tensor          # (m, p) primal node estimates
    P: Tensor          # (m, p) accumulated duals  p_l = sum_k (u_lk + v_lk)
    t: Tensor          # ()     int32 iteration counter, on the device
    progress: Tensor   # ()     stop statistic: max|B_t - B_{t-1}| (or a
    #                           residual substituted by ``run_tol``)


class Problem(NamedTuple):
    """Static per-fit data: node-local design blocks plus the precomputed
    per-node scalars of update (7a').  ``mask`` (m, n) marks real samples
    for uneven-n fits; None means every row counts."""
    X: Tensor                     # (m, n, p)
    y: Tensor                     # (m, n)
    deg: Tensor                   # (m,)
    rho: Tensor                   # (m,)
    omega: Tensor                 # (m,)
    mask: Optional[Tensor] = None


# Backends of the local update / round, selected by ``cfg.backend``:
#   "jnp"             the reference batched ``local_update`` (plain torch;
#                     the name is kept from the JAX package)
#   "pallas"          the two-pass local-update kernel, nodes as a grid axis
#   "megakernel"      the whole-round kernel (fp32 compute)
#   "megakernel_bf16" same, X and the dot operands bf16; accumulators fp32
# "auto" defers to the legacy ``use_pallas`` flag.
MEGAKERNEL_BACKENDS = ("megakernel", "megakernel_bf16")
BACKENDS = ("auto", "jnp", "pallas") + MEGAKERNEL_BACKENDS


def resolve_backend(cfg, use_pallas: Optional[bool] = None) -> str:
    """Normalize ``cfg.backend`` (+ the legacy use_pallas override)."""
    backend = getattr(cfg, "backend", "auto").replace("-", "_")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        pallas = cfg.use_pallas if use_pallas is None else use_pallas
        return "pallas" if pallas else "jnp"
    return backend


def problem_dtype(cfg):
    """Compute dtype for X (the mixed-precision knob): bf16 only under the
    megakernel_bf16 backend; accumulators stay fp32 regardless."""
    if resolve_backend(cfg) == "megakernel_bf16":
        return torch.bfloat16
    return torch.float32


def kernel_x(X: Tensor, cfg) -> Tensor:
    """X in the backend's compute dtype, contiguous, with a 16-byte
    aligned base: the stream instances' bulk copies need it, so an offset
    view is copied to a fresh buffer (a cast copies already)."""
    Xc = X.to(problem_dtype(cfg)).contiguous()
    if Xc.data_ptr() % 16:
        Xc = Xc.clone()
    return Xc


def make_problem(X: Tensor, y: Tensor, W: Tensor, cfg,
                 mask: Optional[Tensor] = None,
                 rho: Optional[Tensor] = None) -> Problem:
    """Assemble a ``Problem`` from stacked node blocks and the adjacency.

    rho/omega are always computed in the incoming (fp32) precision; X is
    cast to the backend's compute dtype *afterwards*, so the bf16 mode
    changes only the per-round matmul operands, never the step sizes
    (``kernel_x`` makes the copy of X).  With ``repro_torch.spans`` on,
    the two are the spans ``solver.rho`` and ``solver.kernel_x``.
    """
    deg = torch.sum(W, dim=1)
    if rho is None:
        with spans.span("solver.rho"):
            rho = compute_rho(X, cfg.h, cfg.kernel, cfg.rho_safety,
                              mask=mask)
    omega = 1.0 / (2.0 * cfg.tau * deg + rho + cfg.lam0)
    with spans.span("solver.kernel_x"):
        Xc = kernel_x(X, cfg)
    return Problem(Xc, y, deg, rho, omega, mask)


def from_numpy(X, y, deg, rho, omega, B, P, t, *, device=None):
    """The JAX package's ``Problem`` / ``SolverState`` arrays, as numpy,
    turned into the port's fp32 ``(Problem, SolverState)``; ``device``
    defaults to CUDA."""
    dev = torch.device("cuda" if device is None else device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    prob = Problem(f32(X), f32(y), f32(deg), f32(rho), f32(omega))
    state = SolverState(f32(B), f32(P),
                        torch.tensor(int(t), dtype=torch.int32, device=dev),
                        torch.tensor(math.inf, dtype=torch.float32,
                                     device=dev))
    return prob, state


def _matvec(X: Tensor, v: Tensor) -> Tensor:
    """Per-node X_l @ v_l: X (m, n, p), v (m, p) -> (m, n)."""
    return torch.bmm(X, v[..., None])[..., 0]


def _rmatvec(X: Tensor, w: Tensor) -> Tensor:
    """Per-node X_l^T @ w_l: X (m, n, p), w (m, n) -> (m, p)."""
    return torch.bmm(X.transpose(1, 2), w[..., None])[..., 0]


def local_update(X: Tensor, y: Tensor, beta: Tensor, p_dual: Tensor,
                 neigh_term: Tensor, rho, omega, lam_vec, *, h: float,
                 kernel: str, mask: Optional[Tensor] = None) -> Tensor:
    """THE Algorithm-1 primal update (7a'), for one node or a node stack.

    One node: X (n, p), y (n,), beta/p_dual/neigh_term (p,), rho/omega
    scalars.  A stack: X (m, n, p), y (m, n), beta/p_dual/neigh_term
    (m, p), rho/omega (m,).  lam_vec is a scalar or a (p,) per-coordinate
    l1 level; ``neigh_term`` is the precomputed
    tau * (deg_l * beta_l + sum_{k in N(l)} beta_k); mask (n,) or (m, n).
    """
    if X.dim() == 2:
        return local_update(
            X[None], y[None], beta[None], p_dual[None], neigh_term[None],
            torch.as_tensor(rho).reshape(1), torch.as_tensor(omega).reshape(1),
            lam_vec, h=h, kernel=kernel,
            mask=None if mask is None else mask[None])[0]
    kern = losses.get_kernel(kernel)
    Xc = X.to(torch.promote_types(X.dtype, beta.dtype))
    margin = y * _matvec(Xc, beta)
    w = kern.dloss(margin, h) * y
    if mask is None:
        n_eff = X.shape[1]
    else:
        w = w * mask
        n_eff = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    grad = _rmatvec(Xc, w) / n_eff
    rho = torch.as_tensor(rho, device=beta.device).reshape(-1, 1)
    omega = torch.as_tensor(omega, device=beta.device).reshape(-1, 1)
    z = rho * beta - grad - p_dual + neigh_term
    # declint: disable=R1 the port's local_update, counterpart of repro/core/solver.py's
    return soft_threshold(omega * z, lam_vec * omega)


def _lam_vec(lam, lam_weights, p_dim: int, device) -> Tensor:
    """The (p,) fp32 per-coordinate l1 level."""
    if lam_weights is None:
        return torch.full((p_dim,), float(lam), dtype=torch.float32,
                          device=device)
    return (lam * lam_weights).to(torch.float32)


def _hold(keep: Tensor, new: SolverState, old: SolverState) -> SolverState:
    """Leafwise ``keep ? new : old`` without a host sync."""
    return SolverState(*(torch.where(keep, a, b) for a, b in zip(new, old)))


def make_step(cfg, neighbor_sum: Callable[[Tensor], Tensor], *,
              use_pallas: Optional[bool] = None,
              W: Optional[Tensor] = None):
    """Build one ``(lam, lam_weights)`` Algorithm-1 round.

    ``neighbor_sum(B) -> (m, p)`` supplies  (W B)_l = sum_{k in N(l)} b_k.
    The local-update backend comes from ``cfg.backend``
    (``resolve_backend``): the plain reference, the two-pass local-update
    kernel (``use_pallas`` is the legacy override), or the round kernel
    (fp32 / bf16-compute).

    Dense drivers additionally pass the adjacency ``W``: under a megakernel
    backend the returned step then carries ``step.round_block`` —
    ``round_block(prob, state, lam, lam_weights, num_rounds=,
    rounds_active=, want_kkt=)`` runs k rounds (and the KKT stop
    statistic) in ONE kernel launch, which ``run_fixed``/``run_tol`` use as
    their fast path.  Sharded engines (no W) get one two-pass kernel
    launch per round; ``step.cached_round`` and ``step.neighbor_sum`` serve
    ``run_fixed_cached``.

    With ``cfg.sanitize`` the step comes back wrapped with the E1-E6 term
    checks (``sanitize.checked_step``) and without ``round_block``: the
    round kernel hides the per-term dataflow the checks localize.

    Returns ``step(prob, state, lam, lam_weights=None) -> SolverState``.
    """
    tau, h, kernel = cfg.tau, cfg.h, cfg.kernel
    backend = resolve_backend(cfg, use_pallas)

    def _primal(prob, B, P, neigh_term, lam_vec):
        """B_new via the selected backend.  The kernels have no sample-mask
        operand: masked fits (uneven n) take the reference backend, or
        held-out rows would silently count as real samples.  The two-pass
        kernels need no co-resident grid, so the residency rule of the
        round kernel does not gate them."""
        if backend == "pallas" and prob.mask is None:
            from repro_torch.kernels import ops
            return ops.csvm_local_update(
                prob.X, prob.y, B, P, neigh_term, prob.rho, prob.omega,
                lam_vec, h=h, kernel=kernel)
        if backend in MEGAKERNEL_BACKENDS and prob.mask is None:
            from repro_torch.kernels import ops
            return ops.csvm_block_update(
                prob.X, prob.y, B, P, neigh_term, prob.rho, prob.omega,
                lam_vec, h=h, kernel=kernel)
        return local_update(prob.X, prob.y, B, P, neigh_term, prob.rho,
                            prob.omega, lam_vec, h=h, kernel=kernel,
                            mask=prob.mask)

    def step(prob: Problem, state: SolverState, lam,
             lam_weights: Optional[Tensor] = None) -> SolverState:
        B, P = state.B, state.P
        neigh_term = tau * (prob.deg[:, None] * B + neighbor_sum(B))
        lam_vec = _lam_vec(lam, lam_weights, B.shape[-1], B.device)
        B_new = _primal(prob, B, P, neigh_term, lam_vec)
        P_new = P + tau * (prob.deg[:, None] * B_new - neighbor_sum(B_new))
        return SolverState(B_new, P_new, state.t + 1,
                           torch.max(torch.abs(B_new - B)))

    def cached_round(prob: Problem, state: SolverState, S, lam,
                     lam_weights: Optional[Tensor] = None):
        """One round with ``S = neighbor_sum(state.B)`` supplied by the
        caller: the dual update's neighbour sum of B_new is the next
        round's primal one, so ``run_fixed_cached`` carries it across
        rounds — one exchange a round instead of two, the same bits."""
        B, P = state.B, state.P
        neigh_term = tau * (prob.deg[:, None] * B + S)
        lam_vec = _lam_vec(lam, lam_weights, B.shape[-1], B.device)
        B_new = _primal(prob, B, P, neigh_term, lam_vec)
        S_new = neighbor_sum(B_new)
        P_new = P + tau * (prob.deg[:, None] * B_new - S_new)
        return SolverState(B_new, P_new, state.t + 1,
                           torch.max(torch.abs(B_new - B))), S_new

    step.cached_round = cached_round
    step.neighbor_sum = neighbor_sum

    if getattr(cfg, "sanitize", False):
        from repro_torch.core import sanitize
        return sanitize.checked_step(step, cfg, neighbor_sum)

    if backend in MEGAKERNEL_BACKENDS and W is not None:

        def round_block(prob, state, lam, lam_weights, *, num_rounds: int,
                        rounds_active, want_kkt: bool) -> SolverState:
            """``num_rounds`` rounds in one kernel launch; the first
            ``rounds_active`` (an int or a device int tensor, <=
            num_rounds) advance the iterate, the rest are held.
            ``state.progress`` returns as the KKT residual (``want_kkt``)
            or the last active round's max|dB|.  When the residency rule
            refuses the launch, the same rounds run as a loop of single
            rounds, one ``csvm_block_update`` launch each; a masked
            problem loops the reference rounds."""
            from repro_torch.kernels import ops
            lam_vec = _lam_vec(lam, lam_weights, state.B.shape[-1],
                               state.B.device)
            nact = torch.as_tensor(rounds_active, dtype=torch.int32,
                                   device=state.B.device)
            if (prob.mask is None
                    and ops.megakernel_supported(
                        *prob.X.shape, prob.X.dtype, device=prob.X.device,
                        num_rounds=num_rounds)):
                Bn, Pn, stat = ops.csvm_round_block(
                    prob.X, prob.y, state.B, state.P, W, prob.deg, prob.rho,
                    prob.omega, lam_vec, nact, tau=tau, lam0=cfg.lam0, h=h,
                    kernel=kernel, num_rounds=num_rounds, want_kkt=want_kkt)
                return SolverState(Bn, Pn, state.t + nact, stat)

            new = state
            for i in range(num_rounds):
                new = _hold(i < nact, step(prob, new, lam, lam_weights), new)
            if want_kkt:
                return new._replace(
                    progress=kkt_residual(prob, cfg, new.B, lam, lam_weights))
            return new

        step.round_block = round_block

    return step


def init_state(prob: Problem, B0: Optional[Tensor] = None,
               P0: Optional[Tensor] = None) -> SolverState:
    """Accumulators (B, P, progress) live in fp32 even when X is bf16 —
    the mixed-precision discipline keeps state exact across rounds."""
    m, _, p = prob.X.shape
    dev = prob.X.device
    dt = torch.promote_types(prob.X.dtype, torch.float32)
    B = torch.zeros((m, p), dtype=dt, device=dev) if B0 is None else B0
    P = torch.zeros_like(B) if P0 is None else P0
    return SolverState(B, P, torch.zeros((), dtype=torch.int32, device=dev),
                       torch.tensor(math.inf, dtype=dt, device=dev))


def run_fixed(step, prob: Problem, lam, lam_weights=None, *,
              num_iters: int, state: Optional[SolverState] = None,
              track_history: bool = False):
    """Drive ``step`` for a fixed number of rounds.

    Returns the final ``SolverState``; with ``track_history`` also the
    (T, m, p) iterate history.  When ``step`` carries the round kernel's
    ``round_block`` and no history is requested, the whole run is ONE
    kernel launch.
    """
    state = init_state(prob) if state is None else state
    round_block = getattr(step, "round_block", None)
    if round_block is not None and not track_history and num_iters > 0:
        return round_block(prob, state, lam, lam_weights,
                           num_rounds=num_iters, rounds_active=num_iters,
                           want_kkt=False)
    hist = []
    for _ in range(num_iters):
        state = step(prob, state, lam, lam_weights)
        if track_history:
            hist.append(state.B)
    if track_history:
        m, _, p = prob.X.shape
        return state, (torch.stack(hist) if hist else
                       state.B.new_zeros((0, m, p)))
    return state


def run_fixed_cached(step, prob: Problem, lam, lam_weights=None, *,
                     num_iters: int,
                     state: Optional[SolverState] = None) -> SolverState:
    """``run_fixed`` through ``step.cached_round``: the neighbour sum of
    the current iterate is carried from round to round, so every round
    pays one neighbour exchange instead of two, bit for bit the same as
    ``run_fixed``.  Falls back to ``run_fixed`` for a step without
    ``cached_round`` (the sanitizer-wrapped step)."""
    cached = getattr(step, "cached_round", None)
    if cached is None:
        return run_fixed(step, prob, lam, lam_weights, num_iters=num_iters,
                         state=state)
    state = init_state(prob) if state is None else state
    S = step.neighbor_sum(state.B)
    for _ in range(num_iters):
        state, S = cached(prob, state, S, lam, lam_weights)
    return state


def run_tol(step, prob: Problem, lam, lam_weights=None, *, max_iter: int,
            tol: float, state: Optional[SolverState] = None,
            residual_fn=None, axis_name: Optional[str] = None,
            check_every: int = 1) -> SolverState:
    """Drive ``step`` until ``max_iter`` OR the stop statistic <= tol.

    The default statistic is iterate progress max|B_t - B_{t-1}|;
    ``residual_fn(prob, state, lam, lam_weights)`` substitutes e.g. the
    KKT residual (``kkt_residual``).  ``check_every=k`` evaluates the
    statistic only after every k-th round; rounds past ``max_iter`` inside
    a block are held, so the iterate never overshoots and stopping happens
    only on a measured value, at rounds k, 2k, ....  The host reads the
    continue flag once per check.  ``axis_name`` (one mesh axis or a
    tuple) agrees the flag and the statistic across the ranks of those
    axes with a ``pmax``, as JAX does inside ``shard_map``; a rank past
    ``max_iter`` then holds its rounds.

    When ``step`` carries the round kernel's ``round_block`` and the
    statistic is the KKT residual (or plain progress), each k-round block
    plus its statistic is ONE kernel launch, with the active-round count
    ``min(k, max_iter - t)`` computed on the device.
    """
    state = init_state(prob) if state is None else state

    def _flag(s) -> bool:
        f = (s.t < max_iter) & (s.progress > tol)
        if axis_name is not None:
            f = collective("pmax", f.to(torch.int32), axis_name) > 0
        return bool(f)

    def stat(new):
        if residual_fn is not None:
            return residual_fn(prob, new, lam, lam_weights)
        return new.progress

    round_block = getattr(step, "round_block", None)
    use_fused = (round_block is not None and axis_name is None
                 and prob.mask is None
                 and (residual_fn is None
                      or getattr(residual_fn, "kind", None) == "kkt"))

    while _flag(state):
        if use_fused:
            nact = torch.clamp(max_iter - state.t, max=check_every)
            state = round_block(prob, state, lam, lam_weights,
                                num_rounds=check_every, rounds_active=nact,
                                want_kkt=residual_fn is not None)
            continue
        if check_every > 1:
            for _ in range(check_every):
                state = _hold(state.t < max_iter,
                              step(prob, state, lam, lam_weights), state)
        else:
            stepped = step(prob, state, lam, lam_weights)
            state = (stepped if axis_name is None
                     else _hold(state.t < max_iter, stepped, state))
        state = state._replace(progress=stat(state))
        if axis_name is not None:
            state = state._replace(progress=collective(
                "pmax", state.progress, axis_name))
    return state


def kkt_residual_fn(cfg, axis_name=None, node_mask: Optional[Tensor] = None):
    """Adapter factory: the ``residual_fn`` shape ``run_tol`` expects,
    closing over cfg (and the mesh axis and the node mask of the sharded
    engines).  ``fn.kind`` tags the statistic so ``run_tol`` knows the
    round kernel's KKT epilogue computes the same quantity and may fuse
    it.  With ``cfg.sanitize`` the statistic is checked (E7,
    ``sanitize.checked_residual``)."""
    def fn(prob, state, lam, lam_weights):
        return kkt_residual(prob, cfg, state.B, lam, lam_weights,
                            axis_name=axis_name, node_mask=node_mask)
    fn.kind = "kkt"
    if getattr(cfg, "sanitize", False):
        from repro_torch.core import sanitize
        return sanitize.checked_residual(fn, cfg)
    return fn


def kkt_residual(prob: Problem, cfg, B: Tensor, lam,
                 lam_weights: Optional[Tensor] = None, *,
                 axis_name=None,
                 node_mask: Optional[Tensor] = None) -> Tensor:
    """KKT/duality-gap stop statistic for the network problem (eq. 3/4).

      stationarity: the unit-step prox-gradient fixed-point residual at
        beta_bar = mean_l b_l,
          max_j | beta_bar_j - S_{lam_j}(beta_bar_j - g_j) |,
        with g the network-mean smoothed-loss gradient plus
        lam0 * beta_bar (zero exactly at a KKT point of eq. (3)/(4));
      consensus:  max_l |b_l - beta_bar|.

    Returns max(stationarity, consensus).  ``axis_name`` reduces the node
    means and maxes over a mesh axis (``launch.mesh.collective``);
    ``node_mask`` (0/1 per row of B) restricts every node mean and max to
    the real nodes — the chunked engine's zero-padded ghost rows carry
    zero gradients and zero B but must not dilute the network means.
    """
    if node_mask is not None:
        nm = node_mask.to(B.dtype)
        b_sum = torch.sum(B * nm[:, None], dim=0)
        n_real = torch.sum(nm)
        if axis_name is not None:
            b_sum = collective("psum", b_sum, axis_name)
            n_real = collective("psum", n_real, axis_name)
        beta_bar = b_sum / n_real
    else:
        beta_bar = torch.mean(B, dim=0)
        if axis_name is not None:
            beta_bar = collective("pmean", beta_bar, axis_name)
    m = prob.X.shape[0]
    kern = losses.get_kernel(cfg.kernel)
    Xc = prob.X.to(torch.promote_types(prob.X.dtype, B.dtype))
    margin = prob.y * _matvec(Xc, beta_bar.expand(m, -1).contiguous())
    w = kern.dloss(margin, cfg.h) * prob.y
    if prob.mask is None:
        grads = _rmatvec(Xc, w) / prob.X.shape[1]
    else:
        grads = _rmatvec(Xc, w * prob.mask) / torch.clamp(
            torch.sum(prob.mask, dim=1, keepdim=True), min=1.0)
    if node_mask is not None:
        g_sum = torch.sum(grads * nm[:, None], dim=0)
        if axis_name is not None:
            g_sum = collective("psum", g_sum, axis_name)
        g = g_sum / n_real
    else:
        g = torch.mean(grads, dim=0)
        if axis_name is not None:
            g = collective("pmean", g, axis_name)
    g = g + cfg.lam0 * beta_bar
    p_dim = beta_bar.shape[-1]
    if lam_weights is None:
        lam_vec = torch.full((p_dim,), float(lam), dtype=beta_bar.dtype,
                             device=beta_bar.device)
    else:
        lam_vec = lam * lam_weights
    stat = torch.abs(beta_bar - soft_threshold(beta_bar - g, lam_vec))
    dev = torch.abs(B - beta_bar[None, :])
    if node_mask is not None:
        dev = dev * nm[:, None]
    cons = torch.max(dev)
    if axis_name is not None:
        cons = collective("pmax", cons, axis_name)
    return torch.maximum(torch.max(stat), cons)
