"""Decentralized ADMM engines across ranks, in torch: the drivers of
``repro.core.decentral`` over the unified Algorithm-1 step of
``repro_torch.core.solver``, with every collective routed through
``repro_torch.launch.mesh.collective``.

JAX runs these engines under ``shard_map`` over a device mesh from one
controller.  The port runs them SPMD over the ranks of a
``torch.distributed`` group (``repro_torch.launch.ranks`` starts one):
every rank calls the same entry point with the same global arrays, takes
its block of each operand as JAX's ``in_specs`` say (``_shard``), runs
JAX's program on it with the collectives over its mesh lines, and returns
the same global result, assembled as JAX's ``out_specs`` say.  Outside a
group every mesh has one rank, each collective is the identity and each
block the whole array.  The layouts, the padding and the scores are
JAX's:

  - "gather" (any graph): ``all_gather`` of the primal block, then the
    local adjacency rows.
  - "ring" (ring graphs): the two rolls, the shard-boundary rows fixed by
    ``ppermute``s.
  - "block" (any graph, any m): the chunked node-megabatch layout —
    ``BlockTopology.chunk_operands`` gives the diagonal block and the kept
    off-diagonal block diagonals, each rotated in by ``ppermute``; m pads
    to ``ceil(m / ranks) * ranks`` with ghost rows that stay exactly 0.

Engines:

  - ``decsvm_fit_sharded`` / ``decsvm_path_sharded``: one fit, or the
    whole grid one point after another.
  - ``decsvm_fit_chunked`` (fixed rounds, or ``tol=`` with the KKT stop
    masked to the real nodes) / ``decsvm_path_chunked``.
  - ``decsvm_path_mesh``: the grid as cells of a (node, lam) mesh, with
    the modified-BIC or k-fold-CV scores computed in the same program; in
    CV the fold fits join the grid as L·k more cells.  In warm mode a
    "lam" axis larger than 1 hands each shard's boundary solution to the
    next shard and sweeps again (``handoff``).

The builders are cached closures (``functools.lru_cache``), as JAX caches
its jitted programs.  The steps are built without ``W``, so they carry no
``round_block``: under ``megakernel`` / ``megakernel_bf16`` every round
is one ``csvm_block_update`` launch on the rank's block of nodes, under
``pallas`` one ``csvm_local_update`` launch, and a masked cell (CV) takes
the plain rounds.  Every entry point takes ``rho=`` (m,) to fix the step
sizes (and ``cv_rho=`` (k, m) for the CV folds), and ``device=`` as
``admm.decsvm_fit`` does.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import sanitize, solver
from repro_torch.core.admm import ADMMConfig, as_f32, resolve_device
from repro_torch.core.path import PathResult, _grid, _opt
from repro_torch.core.tuning import _host, kfold_masks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import Mesh, P, collective

Tensor = torch.Tensor


def make_node_mesh(n_devices: Optional[int] = None) -> Mesh:
    return mesh_mod.make_node_mesh(n_devices)


def make_node_chunk_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D ("node_chunk",) mesh for the chunked engines."""
    return mesh_mod.make_node_chunk_mesh(n_devices)


def make_node_lam_mesh(n_node: int, n_lam: Optional[int] = None) -> Mesh:
    """2-D mesh with named axes ("node", "lam")."""
    return mesh_mod.make_node_lam_mesh(n_node, n_lam)


def _shard(fn, mesh: Mesh, in_specs, out_specs):
    """``fn`` run on this rank's block of each operand with ``mesh``
    bound, its outputs gathered to the global tensors — the counterpart of
    ``shard_map(fn, mesh, in_specs, out_specs)``.  Specs past the last
    operand given (the mesh program's optional masks) go unused."""

    def run(*args):
        with mesh_mod.bound(mesh):
            local = [mesh_mod.block(a, spec)
                     for a, spec in zip(args, in_specs)]
            return mesh_mod.assemble(fn(*local), out_specs)

    return run


def _neighbor_sum_fn(schedule: str, ndev: int, Wl: Optional[Tensor]):
    """Neighbour-sum backend for ``solver.make_step`` on the "node" axis.

    ``gather``: (W B)_l via ``all_gather`` + the local adjacency rows Wl.
    ``ring``: left+right neighbours by rolling the local rows, the shard
    boundaries fixed with point-to-point permutes.
    """
    if schedule == "ring":

        def ring_sum(Bl):
            up = torch.roll(Bl, -1, 0)        # row i <- row i+1 (local)
            dn = torch.roll(Bl, 1, 0)         # row i <- row i-1 (local)
            fwd = [(d, (d + 1) % ndev) for d in range(ndev)]
            bwd = [(d, (d - 1) % ndev) for d in range(ndev)]
            first_of_next = collective("ppermute", Bl[:1], "node", bwd)
            last_of_prev = collective("ppermute", Bl[-1:], "node", fwd)
            up = torch.cat([up[:-1], first_of_next])
            dn = torch.cat([last_of_prev, dn[1:]])
            return up + dn

        return ring_sum

    def gather_sum(Bl):
        return Wl @ collective("all_gather", Bl, "node")

    return gather_sum


def _local_problem(Xl, yl, degl, rhol, cfg, mask=None) -> solver.Problem:
    omega = 1.0 / (2.0 * cfg.tau * degl + rhol + cfg.lam0)
    return solver.Problem(Xl, yl, degl, rhol, omega, mask)


def _block_neighbor_sum_fn(axis: str, ndev: int, Wd_l: Tensor,
                           Woff_l: Tensor, offsets):
    """Block-sparse chunked neighbour sum: (W B)_l with W viewed as an
    ndev x ndev grid of (mc, mc) blocks — the local diagonal block as a
    dense dot, and each kept block diagonal (``offsets``) as one dot with
    a copy of B rotated to it by ``ppermute`` (k offsets cost k hops).

    Wd_l: (mc, mc) local diagonal block rows; Woff_l: (K, mc, mc) local
    rows of the K kept off-diagonal block diagonals.
    """
    def block_sum(Bl):
        acc = Wd_l @ Bl
        moving = Bl
        prev = 0
        for j, k in enumerate(offsets):
            shift = k - prev
            perm = [(s, (s - shift) % ndev) for s in range(ndev)]
            moving = collective("ppermute", moving, axis, perm)
            acc = acc + Woff_l[j] @ moving
            prev = k
        return acc

    return block_sum


def _padded_omega(degl, rhol, cfg):
    """omega = 1/(2 tau deg + rho + lam0), but 0 on all-zero padded ghost
    rows (deg = rho = 0), where the dense formula divides by lam0.  Real
    rows have denom > 0, so this equals ``_local_problem``'s there."""
    denom = 2.0 * cfg.tau * degl + rhol + cfg.lam0
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, 1.0 / safe, torch.zeros_like(denom))


def _padded_problem(Xl, yl, degl, rhol, cfg, mask=None) -> solver.Problem:
    return solver.Problem(Xl, yl, degl, rhol,
                          _padded_omega(degl, rhol, cfg), mask)


def _zero_state(shape, dtype, device) -> solver.SolverState:
    """Zero SolverState; accumulators are fp32 even when X is bf16."""
    dt = torch.promote_types(dtype, torch.float32)
    return solver.SolverState(
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.tensor(math.inf, dtype=dt, device=device))


def _fit_cells(step, run, cell_problem, lams, cells, lamw, num_iters,
               shape, dtype, device):
    """Cold-started fixed-round fits, one cell after another (JAX ``vmap``s
    them): returns (path (C, m, p), rounds (C,))."""
    path, iters = [], []
    for lam, cell in zip(lams, cells):
        final = run(step, cell_problem(*cell), float(lam), lamw,
                    num_iters=num_iters,
                    state=_zero_state(shape, dtype, device))
        path.append(final.B)
        iters.append(final.t)
    return torch.stack(path), torch.stack(iters)


@functools.lru_cache(maxsize=64)
def build_sharded_admm(m: int, p: int, cfg: ADMMConfig, mesh: Mesh,
                       schedule: str = "gather"):
    """The sharded ADMM loop, cached on (m, p, cfg, mesh, schedule).

    Returns fn (X (m,n,p), y (m,n), W (m,m), deg (m,), rho (m,),
    lam_weights (p,)) -> B (m, p).
    """
    ndev = mesh.shape["node"]
    assert m % ndev == 0, f"m={m} must be divisible by #devices={ndev}"

    def sharded_loop(Xl, yl, Wl, degl, rhol, lamw):
        step = solver.make_step(cfg, _neighbor_sum_fn(schedule, ndev, Wl))
        prob = _local_problem(Xl, yl, degl, rhol, cfg)
        state = _zero_state((Xl.shape[0], p), Xl.dtype, Xl.device)
        return solver.run_fixed(step, prob, cfg.lam, lamw,
                                num_iters=cfg.max_iter, state=state).B

    return _shard(sharded_loop, mesh, (P("node"),) * 5 + (P(),), P("node"))


@functools.lru_cache(maxsize=64)
def build_sharded_path(m: int, p: int, L: int, cfg: ADMMConfig, mesh: Mesh,
                       schedule: str = "gather"):
    """Sharded node x lambda engine: each grid point one cold-started fit
    with the single fit's exchange schedule.

    Returns fn (X, y, W, deg, rho, lams (L,), lam_weights (p,))
    -> path (L, m, p).
    """
    ndev = mesh.shape["node"]
    assert m % ndev == 0, f"m={m} must be divisible by #devices={ndev}"

    def sharded_loop(Xl, yl, Wl, degl, rhol, lams, lamw):
        step = solver.make_step(cfg, _neighbor_sum_fn(schedule, ndev, Wl))
        prob = _local_problem(Xl, yl, degl, rhol, cfg)
        path, _ = _fit_cells(step, solver.run_fixed, lambda: prob,
                             _grid(lams), [()] * L, lamw, cfg.max_iter,
                             (Xl.shape[0], p), Xl.dtype, Xl.device)
        return path

    return _shard(sharded_loop, mesh, (P("node"),) * 5 + (P(), P()),
                  P(None, "node"))


def _prep(X, W, cfg, schedule, rho):
    if schedule == "ring":
        _assert_ring(_host(W))
    Wj = as_f32(W, X.device)
    deg = torch.sum(Wj, dim=1)
    if rho is None:
        rho = solver.compute_rho(X, cfg.h, cfg.kernel, cfg.rho_safety)
    return Wj, deg, rho


def _lamw(lam_weights, p, device) -> Tensor:
    return (torch.ones((p,), dtype=torch.float32, device=device)
            if lam_weights is None else as_f32(lam_weights, device))


def _fold_rhos(X, folds, h, kernel, safety) -> Tensor:
    """Per-fold rho vectors, (k, m)."""
    return torch.stack([solver.compute_rho(X, h, kernel, safety, mask=mk)
                        for mk in folds])


def decsvm_fit_sharded(X, y, W, cfg: ADMMConfig, mesh: Optional[Mesh] = None,
                       schedule: str = "gather", lam_weights=None, *,
                       rho=None, device=None) -> Tensor:
    """Run Algorithm 1 with node state sharded over the "node" axis.

    X: (m, n, p), y: (m, n), W: (m, m).  m must divide the node-axis size
    — or pass ``schedule="block"`` to run the chunked engine
    (``decsvm_fit_chunked``).  lam_weights: optional (p,) per-coordinate
    l1 multipliers (LLA stage 2).  Returns B: (m, p).
    """
    if schedule == "block":
        return decsvm_fit_chunked(X, y, W, cfg, mesh=mesh,
                                  lam_weights=lam_weights, rho=rho,
                                  device=device)
    sanitize.reject_unsupported(cfg, "decsvm_fit_sharded")
    mesh = mesh or make_node_mesh()
    dev = resolve_device(X, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    m, _, p = X.shape
    Wj, deg, rho = _prep(X, W, cfg, schedule, _opt(rho, dev))
    fitted = build_sharded_admm(m, p, cfg, mesh, schedule)
    return fitted(solver.kernel_x(X, cfg), y, Wj, deg, rho,
                  _lamw(lam_weights, p, dev))


def decsvm_path_sharded(X, y, W, lams, cfg: ADMMConfig,
                        mesh: Optional[Mesh] = None,
                        schedule: str = "gather", lam_weights=None, *,
                        rho=None, device=None) -> Tensor:
    """The whole lambda grid with node state sharded over "node".

    X: (m, n, p), y: (m, n), W: (m, m), lams: (L,) decreasing grid.
    Returns the path (L, m, p); cfg.lam is ignored.  ``schedule="block"``
    routes to ``decsvm_path_chunked``.
    """
    if schedule == "block":
        return decsvm_path_chunked(X, y, W, lams, cfg, mesh=mesh,
                                   lam_weights=lam_weights, rho=rho,
                                   device=device)
    sanitize.reject_unsupported(cfg, "decsvm_path_sharded")
    mesh = mesh or make_node_mesh()
    dev = resolve_device(X, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    m, _, p = X.shape
    grid = _grid(lams)
    Wj, deg, rho = _prep(X, W, cfg, schedule, _opt(rho, dev))
    fitted = build_sharded_path(m, p, len(grid), cfg, mesh, schedule)
    return fitted(solver.kernel_x(X, cfg), y, Wj, deg, rho, grid,
                  _lamw(lam_weights, p, dev))


# --------------------------------------------------------------------------
# Chunked node-megabatch engine (schedule="block")
# --------------------------------------------------------------------------


def _as_topology(W, m: int):
    """W as a ``graph.BlockTopology`` of the m nodes of X."""
    from repro_torch.core import graph  # local import: avoid cycle
    top = (W if isinstance(W, graph.BlockTopology)
           else graph.BlockTopology.from_dense(_host(W)))
    if top.m != m:
        raise ValueError(f"W has {top.m} nodes, X has {m}")
    return top


def _pad_rows(a: Tensor, pad: int) -> Tensor:
    """``a`` with ``pad`` all-zero rows appended (no copy when pad = 0)."""
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def _chunk_prep(X, y, W, cfg, mesh, rho=None):
    """Pad (X, y) with all-zero ghost nodes to m_pad = ceil(m/ndev)*ndev
    and build the block-sparse neighbour-sum operands.  Ghost rows (X = 0,
    y = 0, W rows and columns 0) are exact fixed points of the update:
    deg = rho = 0 and omega = 0 (``_padded_omega``), so their B and P stay
    zero through every round and need no sample mask.  At one rank
    m_pad = m and nothing is padded.  ``rho`` (m,) is padded with zeros,
    the rho of a ghost row."""
    ndev = mesh.shape["node_chunk"]
    top = _as_topology(W, X.shape[0])
    m = X.shape[0]
    W_diag, offsets, W_off = top.chunk_operands(ndev)
    m_pad = W_diag.shape[0]
    pad = m_pad - m
    dev = X.device
    Xp, yp = _pad_rows(X, pad), _pad_rows(y, pad)
    deg = np.zeros((m_pad,), np.float32)
    deg[:m] = top.degrees()
    nmask = np.zeros((m_pad,), np.float32)
    nmask[:m] = 1.0
    rho = (solver.compute_rho(Xp, cfg.h, cfg.kernel, cfg.rho_safety)
           if rho is None else _pad_rows(rho, pad))
    ops = dict(X=solver.kernel_x(Xp, cfg), y=yp,
               W_diag=as_f32(W_diag, dev), W_off=as_f32(W_off, dev),
               deg=as_f32(deg, dev), rho=rho, nmask=as_f32(nmask, dev))
    return ops, offsets, m_pad


@functools.lru_cache(maxsize=64)
def build_chunked_admm(m_pad: int, p: int, cfg: ADMMConfig, mesh: Mesh,
                       offsets, tol: Optional[float] = None,
                       stop_rule: str = "kkt", check_every: int = 4):
    """The chunked ADMM loop: ceil(m/ndev) nodes per rank.

    ``tol=None`` runs cfg.max_iter fixed rounds (``run_fixed_cached``:
    one neighbour exchange a round); with a tol the KKT (or progress)
    statistic early-stops, reduced over "node_chunk" with the ghost rows
    masked out of the network means.

    Returns fn (X (m_pad,n,p), y, W_diag (m_pad,mc), W_off (K,m_pad,mc),
    deg, rho, lam_weights (p,), node_mask (m_pad,)) -> (B (m_pad, p),
    rounds).
    """
    ndev = mesh.shape["node_chunk"]
    assert m_pad % ndev == 0, (m_pad, ndev)

    def chunk_loop(Xl, yl, Wd, Woff, degl, rhol, lamw, nmask):
        nbr = _block_neighbor_sum_fn("node_chunk", ndev, Wd, Woff, offsets)
        step = solver.make_step(cfg, nbr)
        prob = _padded_problem(Xl, yl, degl, rhol, cfg)
        state = _zero_state((Xl.shape[0], p), Xl.dtype, Xl.device)
        if tol is None:
            final = solver.run_fixed_cached(step, prob, cfg.lam, lamw,
                                            num_iters=cfg.max_iter,
                                            state=state)
        else:
            residual_fn = (solver.kkt_residual_fn(
                cfg, axis_name="node_chunk", node_mask=nmask)
                if stop_rule == "kkt" else None)
            final = solver.run_tol(step, prob, cfg.lam, lamw,
                                   max_iter=cfg.max_iter, tol=tol,
                                   state=state, residual_fn=residual_fn,
                                   axis_name="node_chunk",
                                   check_every=check_every)
        return final.B, final.t

    nc = "node_chunk"
    return _shard(chunk_loop, mesh,
                  (P(nc), P(nc), P(nc), P(None, nc), P(nc), P(nc), P(),
                   P(nc)), (P(nc), P()))


@functools.lru_cache(maxsize=64)
def build_chunked_path(m_pad: int, p: int, L: int, cfg: ADMMConfig,
                       mesh: Mesh, offsets):
    """Chunked lambda-grid engine: each grid point one cold-started
    ``run_fixed_cached`` fit on the node chunking.

    Returns fn (X, y, W_diag, W_off, deg, rho, lams (L,), lam_weights (p,))
    -> path (L, m_pad, p).
    """
    ndev = mesh.shape["node_chunk"]
    assert m_pad % ndev == 0, (m_pad, ndev)

    def chunk_loop(Xl, yl, Wd, Woff, degl, rhol, lams, lamw):
        nbr = _block_neighbor_sum_fn("node_chunk", ndev, Wd, Woff, offsets)
        step = solver.make_step(cfg, nbr)
        prob = _padded_problem(Xl, yl, degl, rhol, cfg)
        path, _ = _fit_cells(step, solver.run_fixed_cached, lambda: prob,
                             _grid(lams), [()] * L, lamw, cfg.max_iter,
                             (Xl.shape[0], p), Xl.dtype, Xl.device)
        return path

    nc = "node_chunk"
    return _shard(chunk_loop, mesh,
                  (P(nc), P(nc), P(nc), P(None, nc), P(nc), P(nc), P(),
                   P()), P(None, nc))


def decsvm_fit_chunked(X, y, W, cfg: ADMMConfig, mesh: Optional[Mesh] = None,
                       lam_weights=None, tol: Optional[float] = None,
                       stop_rule: str = "kkt", check_every: int = 4, *,
                       rho=None, device=None):
    """Run Algorithm 1 with each rank owning a contiguous chunk of
    ceil(m/ndev) nodes.

    ``W`` may be a dense (m, m) adjacency or a ``graph.BlockTopology``.
    Returns B (m, p); with ``tol`` returns (B (m, p), rounds).
    """
    sanitize.reject_unsupported(cfg, "decsvm_fit_chunked")
    mesh = mesh or make_node_chunk_mesh()
    dev = resolve_device(X, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    m, _, p = X.shape
    ops, offsets, m_pad = _chunk_prep(X, y, W, cfg, mesh, _opt(rho, dev))
    fitted = build_chunked_admm(m_pad, p, cfg, mesh, offsets, tol=tol,
                                stop_rule=stop_rule, check_every=check_every)
    B, t = fitted(ops["X"], ops["y"], ops["W_diag"], ops["W_off"],
                  ops["deg"], ops["rho"], _lamw(lam_weights, p, dev),
                  ops["nmask"])
    B = B[:m]
    return (B, t) if tol is not None else B


def decsvm_path_chunked(X, y, W, lams, cfg: ADMMConfig,
                        mesh: Optional[Mesh] = None, lam_weights=None, *,
                        rho=None, device=None) -> Tensor:
    """Whole lambda grid through the chunked engine.

    Returns the path (L, m, p); for selection in the same program use
    ``decsvm_path_mesh(schedule="block")``.
    """
    sanitize.reject_unsupported(cfg, "decsvm_path_chunked")
    mesh = mesh or make_node_chunk_mesh()
    dev = resolve_device(X, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    m, _, p = X.shape
    grid = _grid(lams)
    ops, offsets, m_pad = _chunk_prep(X, y, W, cfg, mesh, _opt(rho, dev))
    fitted = build_chunked_path(m_pad, p, len(grid), cfg, mesh, offsets)
    path = fitted(ops["X"], ops["y"], ops["W_diag"], ops["W_off"],
                  ops["deg"], ops["rho"], grid, _lamw(lam_weights, p, dev))
    return path[:, :m]


# --------------------------------------------------------------------------
# The 2-D (node, lam) mesh engine
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def build_mesh_path(m: int, p: int, C: int, cfg: ADMMConfig, mesh: Mesh,
                    schedule: str = "gather", mode: str = "batched",
                    tol: float = 1e-6, stop_rule: str = "kkt",
                    with_masks: bool = False, check_every: int = 4,
                    handoff: bool = True, offsets=(),
                    m_real: Optional[int] = None):
    """The (node, lam) mesh program, cached on all arguments.

    Grid *cells* — (lambda, sample-mask) pairs when ``with_masks``, so CV
    folds ride the same axis as plain grid points — live on "lam", node
    state on "node" ("node_chunk" under ``schedule="block"``).  Fits AND
    scoring run in the one program: per cell it returns (modified BIC on
    the in-mask data, held-out hinge on the mask complement), reduced over
    the node axis.

    Returns fn (X, y, Wop, deg, cell_lams (C,), cell_rho (C, m),
    lam_weights (p,)[, cell_masks (C, m, n)]) -> (path (C, m, p), scores
    (C, 2), iters (C,)); ``Wop`` is W, or the (W_diag, W_off, node_mask)
    triple of the block schedule.

    mode "batched": every cell cold-started for cfg.max_iter rounds
    (``run_fixed_cached`` under the block schedule, ``run_fixed``
    otherwise).  mode "warm": continuation over the cells in order, each
    stopped by ``stop_rule`` every ``check_every`` rounds, the stop agreed
    over the node axis (and "lam" under the block and ring schedules);
    wherever lambda goes back up (a fold-block boundary under CV) the fit
    restarts from zero.

    ``handoff`` (warm mode, "lam" axis larger than 1): after the first
    sweep each lam shard ``ppermute``s its last solution and its lambda
    one shard along "lam" (shard 0 receives zeros, lambda 0) and sweeps
    its cells again, each warm-started from the cell before it — the
    first from the neighbouring shard's — wherever lambda still
    decreases, so continuation crosses shard boundaries as on the dense
    warm path.  Where it does not apply (shard 0, a fold-block boundary)
    the cell resumes its first-sweep iterate and round count.  ``iters``
    reports the second sweep's rounds, as JAX's does.
    ``m_real`` (< m when padded) corrects every scoring mean for the ghost
    rows.
    """
    if mode not in ("warm", "batched"):
        raise ValueError(f"mode {mode!r} not in ('warm', 'batched')")
    if stop_rule not in ("kkt", "progress"):
        raise ValueError(f"stop_rule {stop_rule!r} not in ('kkt', 'progress')")
    nax = "node_chunk" if schedule == "block" else "node"
    nn, nl = mesh.shape[nax], mesh.shape["lam"]
    assert m % nn == 0, f"m={m} must be divisible by node axis={nn}"
    assert C % nl == 0, f"cells={C} must be divisible by lam axis={nl}"
    m_real = m if m_real is None else m_real

    def prog(Xl, yl, Wop, degl, cell_lams, cell_rho, lamw, cell_masks=None):
        if schedule == "block":
            Wd, Woff, nmask = Wop
            nbr = _block_neighbor_sum_fn(nax, nn, Wd, Woff, offsets)
        else:
            nmask = None
            nbr = _neighbor_sum_fn(schedule, nn, Wop)
        step = solver.make_step(cfg, nbr)
        m_local, n, _ = Xl.shape
        lams = _grid(cell_lams)
        masks = ([None] * len(lams) if cell_masks is None
                 else list(cell_masks))
        cells = list(zip(cell_rho, masks))

        def cell_problem(rhoc, maskc):
            if schedule == "block":
                return _padded_problem(Xl, yl, degl, rhoc, cfg, mask=maskc)
            return _local_problem(Xl, yl, degl, rhoc, cfg, mask=maskc)

        shape, dev = (m_local, p), Xl.device
        if mode == "batched":
            run = (solver.run_fixed_cached if schedule == "block"
                   else solver.run_fixed)
            path, iters = _fit_cells(step, run, cell_problem, lams, cells,
                                     lamw, cfg.max_iter, shape, Xl.dtype,
                                     dev)
        else:
            residual_fn = (solver.kkt_residual_fn(cfg, axis_name=nax,
                                                  node_mask=nmask)
                           if stop_rule == "kkt" else None)
            # the block and ring schedules agree the stop over both axes
            # (their exchanges rendezvous mesh-wide), gather per lam column
            stop_axes = (nax, "lam") if schedule in ("block", "ring") else nax

            def fit_from(B_init, lam, rhoc, maskc, t0=0):
                state = _zero_state(shape, Xl.dtype, dev)._replace(
                    B=B_init, t=torch.tensor(t0, dtype=torch.int32,
                                             device=dev))
                return solver.run_tol(step, cell_problem(rhoc, maskc),
                                      float(lam), lamw,
                                      max_iter=cfg.max_iter, tol=tol,
                                      state=state, residual_fn=residual_fn,
                                      axis_name=stop_axes,
                                      check_every=check_every)

            B_prev, lam_prev = _zero_state(shape, Xl.dtype, dev).B, math.inf
            path, iters = [], []
            for lam, (rhoc, maskc) in zip(lams, cells):
                # continuation only while lambda decreases; at a fold-block
                # boundary lambda jumps back up: restart cold there
                B_init = (B_prev if lam <= lam_prev
                          else torch.zeros_like(B_prev))
                final = fit_from(B_init, lam, rhoc, maskc)
                B_prev, lam_prev = final.B, lam
                path.append(final.B)
                iters.append(final.t)
            if handoff and nl > 1:
                perm = [(j, j + 1) for j in range(nl - 1)]
                B_prev = collective("ppermute", B_prev, "lam", perm)
                lam_prev = float(collective(
                    "ppermute", torch.tensor([float(lam_prev)], device=dev),
                    "lam", perm)[0])
                for c, (lam, (rhoc, maskc)) in enumerate(zip(lams, cells)):
                    cont = lam <= lam_prev
                    final = fit_from(B_prev if cont else path[c], lam, rhoc,
                                     maskc, 0 if cont else int(iters[c]))
                    B_prev, lam_prev = final.B, lam
                    path[c], iters[c] = final.B, final.t
            path, iters = torch.stack(path), torch.stack(iters)

        # -- fused scoring (modified BIC + held-out hinge), summed over the
        # node axis in fp32 whatever X's compute dtype; every mean uses the
        # real node count (ghost rows have margin 0, hinge 1 per sample)
        N_total = m_real * n
        Xf = Xl.to(torch.float32)
        margins = (torch.bmm(Xf, path.permute(1, 2, 0)).permute(2, 0, 1)
                   * yl[None])                                # (C, m, n)
        hinge = torch.clamp(1.0 - margins, min=0.0)
        if nmask is not None:
            hinge = hinge * nmask[None, :, None]
        if cell_masks is None:
            hinge_in = collective("psum", torch.sum(hinge, dim=(1, 2)), nax)
            n_in = float(N_total)
            val_hinge = torch.zeros((len(lams),), dtype=torch.float32,
                                    device=dev)
        else:
            hinge_in = collective(
                "psum", torch.sum(hinge * cell_masks, dim=(1, 2)), nax)
            val = 1.0 - cell_masks
            if nmask is not None:
                val = val * nmask[None, :, None]
            hinge_out = collective("psum", torch.sum(hinge * val, dim=(1, 2)),
                                   nax)
            n_out = collective("psum", torch.sum(val, dim=(1, 2)), nax)
            n_in = collective("psum", torch.sum(cell_masks, dim=(1, 2)), nax)
            val_hinge = hinge_out / torch.clamp(n_out, min=1.0)
        supp = collective(
            "psum", torch.sum((torch.abs(path) > 1e-8).to(torch.float32),
                              dim=(1, 2)), nax)
        bic = (hinge_in / n_in
               + math.sqrt(math.log(N_total)) * math.log(p)
               * (supp / m_real) / N_total)
        scores = torch.stack([bic, val_hinge], dim=-1)         # (C, 2)
        return path, scores, iters

    wspec = ((P(nax), P(None, nax), P(nax)) if schedule == "block"
             else P(nax))
    in_specs = (P(nax), P(nax), wspec, P(nax), P("lam"), P("lam", nax), P(),
                P("lam", nax))
    return _shard(prog, mesh, in_specs, (P("lam", nax), P("lam"), P("lam")))


def decsvm_path_mesh(X, y, W, lams, cfg: ADMMConfig,
                     mesh: Optional[Mesh] = None, schedule: str = "gather",
                     mode: str = "batched", tol: float = 1e-6,
                     lam_weights=None, stop_rule: str = "kkt",
                     criterion: str = "bic", cv_folds: int = 5,
                     cv_seed: int = 0, check_every: int = 4,
                     handoff: bool = True, *, rho=None, cv_rho=None,
                     device=None):
    """Lambda path on a (node, lam) mesh, with selection.

    With ``criterion="cv"`` the k-fold train masks join the grid as extra
    cells — L*(1+k) cells — so full-data fits, fold fits, and both scoring
    rules run in one program; the criterion is the held-out hinge averaged
    over the folds.  Returns ``repro_torch.core.path.PathResult`` (tensors
    on the device) whose ``criteria`` is the selected rule's score per
    grid point.  ``schedule="block"`` runs the chunked layout on a
    ("node_chunk", "lam") mesh: any m, and ``W`` may be a
    ``graph.BlockTopology``.  ``rho`` (m,) and ``cv_rho`` (k, m) fix the
    step sizes of the full-data and of the fold cells.  Warm mode with
    ``handoff`` (the default) carries continuation across the shards of a
    "lam" axis larger than 1 (``build_mesh_path``).  cfg.lam is ignored
    (the grid supplies lambda).
    """
    sanitize.reject_unsupported(cfg, "decsvm_path_mesh")
    dev = resolve_device(X, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    m, n, p = X.shape
    lams = _grid(lams)
    L = len(lams)
    if criterion not in ("bic", "cv"):
        raise ValueError(f"criterion {criterion!r} not in ('bic', 'cv')")
    C = L * (1 + cv_folds) if criterion == "cv" else L
    chunked = schedule == "block"

    if mesh is None:
        nn, nl = _choose_mesh_shape(m, C, mesh_mod.device_count(),
                                    chunked=chunked)
        mesh = (mesh_mod.make_chunk_lam_mesh(nn, nl) if chunked
                else make_node_lam_mesh(nn, nl))
    nax = "node_chunk" if chunked else "node"
    nn = mesh.shape[nax]

    if chunked:
        top = _as_topology(W, m)
        W_diag, offsets, W_off = top.chunk_operands(nn)
        m_work = W_diag.shape[0]
        pad = m_work - m
        X, y = _pad_rows(X, pad), _pad_rows(y, pad)
        deg_np = np.zeros((m_work,), np.float32)
        deg_np[:m] = top.degrees()
        nmask_np = np.zeros((m_work,), np.float32)
        nmask_np[:m] = 1.0
        row_valid = nmask_np
    else:
        if schedule == "ring":
            _assert_ring(_host(W))
        offsets, m_work, pad = (), m, 0
        row_valid = np.ones((m,), np.float32)

    rho_full = (solver.compute_rho(X, cfg.h, cfg.kernel, cfg.rho_safety)
                if rho is None else _pad_rows(as_f32(rho, dev), pad))
    if criterion == "cv":
        folds = kfold_masks(m, n, cv_folds, seed=cv_seed)
        if chunked:                        # ghost rows: mask 0 everywhere
            folds = np.concatenate(
                [folds, np.zeros((cv_folds, m_work - m, n), folds.dtype)],
                axis=1)
        folds_t = as_f32(folds, dev)
        ones = as_f32(row_valid, dev)[None, :, None].expand(L, m_work, n)
        cell_masks = torch.cat([ones] + [f.expand(L, m_work, n)
                                         for f in folds_t])
        cell_lams = np.concatenate([lams] * (1 + cv_folds))
        fold_rho = (_fold_rhos(X, folds_t, cfg.h, cfg.kernel,
                               cfg.rho_safety) if cv_rho is None else
                    torch.stack([_pad_rows(r, pad)
                                 for r in as_f32(cv_rho, dev)]))
        cell_rho = torch.cat([rho_full.expand(L, m_work)]
                             + [r.expand(L, m_work) for r in fold_rho])
    else:
        cell_masks, cell_lams = None, lams
        cell_rho = rho_full.expand(L, m_work)
    assert C == len(cell_lams)

    if chunked:
        Wop = (as_f32(W_diag, dev), as_f32(W_off, dev),
               as_f32(nmask_np, dev))
        deg = as_f32(deg_np, dev)
    else:
        Wop = as_f32(W, dev)
        deg = torch.sum(Wop, dim=1)

    # X narrows to the backend's compute dtype only now: rho (above) and
    # the scoring operands' accumulation stay fp32
    operands = [solver.kernel_x(X, cfg), y, Wop, deg, cell_lams, cell_rho,
                _lamw(lam_weights, p, dev)]
    if cell_masks is not None:
        operands.append(cell_masks)

    fitted = build_mesh_path(m_work, p, C, cfg, mesh, schedule, mode, tol,
                             stop_rule, with_masks=cell_masks is not None,
                             check_every=check_every, handoff=handoff,
                             offsets=offsets, m_real=m)
    path_cells, scores, iters = fitted(*operands)

    path = path_cells[:L, :m]
    if criterion == "cv":
        criteria = torch.mean(scores[L:, 1].reshape(cv_folds, L), dim=0)
    else:
        criteria = scores[:L, 0]
    i = torch.argmin(criteria)
    lams_t = torch.as_tensor(lams, device=dev)
    return PathResult(lams_t[i], path[i], lams_t, path, criteria, iters[:L])


def _choose_mesh_shape(m: int, C: int, ndev: int, chunked: bool = False):
    """Pick (node, lam) axis sizes: use every device, maximize balance.
    ``chunked`` drops the m-divisibility constraint (the block schedule
    pads the tail chunk), so only the cell count restricts the split."""
    best = None
    for nn in range(1, ndev + 1):
        if ndev % nn:
            continue
        nl = ndev // nn
        if (not chunked and m % nn) or C % nl:
            continue
        key = (min(nn, nl), nl)        # balanced first, then grid-parallel
        if best is None or key > best[0]:
            best = (key, (nn, nl))
    if best is None:
        raise ValueError(
            f"no (node, lam) split of {ndev} devices divides m={m} and "
            f"cells={C}; pass an explicit mesh")
    return best[1]


def _assert_ring(W: np.ndarray) -> None:
    m = W.shape[0]
    expect = np.zeros_like(np.asarray(W))
    for i in range(m):
        expect[i, (i + 1) % m] = expect[i, (i - 1) % m] = 1.0
    if not np.array_equal(np.asarray(W) != 0, expect != 0):
        raise ValueError("schedule='ring' requires a ring-ordered adjacency")


def consensus_mix(grads: Tensor, Wmix: Tensor, axis: str = "node") -> Tensor:
    """One Metropolis mixing round of per-node tensors on the "node" axis.

    grads: (m_local, ...) this rank's block; Wmix: (m_local, m) its
    mixing rows.  Call it with the mesh bound (``launch.mesh.bound``): the
    blocks are gathered over the axis's ranks.
    """
    flat = grads.reshape(grads.shape[0], -1)
    all_flat = collective("all_gather", flat, axis)
    return (Wmix @ all_flat).reshape(grads.shape)
