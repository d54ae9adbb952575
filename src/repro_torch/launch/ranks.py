"""Ranks of one ``torch.distributed`` group on one host, and the
decentralized engines driven across them.

    python3 -m repro_torch.launch.ranks --ranks 4            # on the card(s)

``spawn(fn, ranks, args)`` starts ``ranks`` processes (``torch.
multiprocessing``, the spawn start method), joins them in one group and
returns ``fn(rank, *args)`` of each, by rank.  The group's backend follows
where the ranks are placed, never a failure: NCCL when each rank has a
card of its own, gloo when the ranks share card 0 (fewer cards than
ranks) or run on the CPU.  Each rank sets its card before any CUDA work,
so ``device="cuda"`` means its own.  The group meets through a file store
in a fresh temporary directory (no TCP port to contend for).  A rank that
raises, or a run past the deadline, fails the call with ``RankFailure``;
the other ranks are killed.

The cases (``_cases``) drive the port's engines at full size across the
ranks — each rank draws the problem on its card from the seed
(``device_problem``), runs every case, and returns its results, its
kernel launches by kernel and instance, their device time (CUDA events),
and the host time its collectives took — and the parent holds each case
against the same entry point at one rank on the same draw, with the same
kernel backend and with the plain ``"jnp"`` update (``run_cases``,
``check_cases``).  ``chip_smoke.py`` runs them as its phase 4d.  The rank
workers import nothing of JAX; the kernels are built in the parent before
the ranks start, so the ranks only load the libraries.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# the gates: fp32 results of the same program in another summation order
# (the repo's fp32 tier); the KKT stop level of the warm paths, and that
# of the chunked fit at full size, where it fires before MAX_ITER
TOL = 1e-5
KKT_TOL = 1e-3
CHUNK_TOL = 2e-2
CHECK_EVERY = 4
# the cases' rounds, the full-size grid (the lambda path's), and the
# design-size grid (its warm paths run twice across the ranks)
MAX_ITER = 300
PATH_NUM = 12
DESIGN_NUM = 4


class RankFailure(RuntimeError):
    """A rank raised, exited, or outlived the deadline."""


def placement(ranks: int, device: str = "cuda"):
    """(backend, card of each rank): one card a rank under NCCL when there
    are enough cards, else every rank on card 0 under gloo; gloo and no
    card on the CPU."""
    if torch.device(device).type == "cpu":
        return "gloo", [None] * ranks
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    if torch.cuda.device_count() >= ranks:
        return "nccl", list(range(ranks))
    return "gloo", [0] * ranks


def _join_group(rank: int, world: int, backend: str, card: Optional[int],
                init_method: str, timeout_s: float) -> None:
    """This process as ``rank`` of the group: its card first, then the
    group (one host: the sockets stay on the loopback device)."""
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if card is not None:
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _worker(rank, fn, args, world, backend, cards, store, out_dir,
            threads, timeout_s):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    _join_group(rank, world, backend, cards[rank], f"file://{store}",
                timeout_s)
    try:
        result = fn(rank, *args)
        tmp = Path(out_dir) / f"result-{rank}.tmp"
        torch.save(result, tmp)
        os.replace(tmp, Path(out_dir) / f"result-{rank}.pt")
    except BaseException:
        # for the parent's message: a rank whose peer died fails too, and
        # may be the first failure the parent sees
        (Path(out_dir) / f"error-{rank}.txt").write_text(
            traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, ranks: int, args=(), *, device: str = "cuda",
          deadline_s: float = 600.0, timeout_s: float = 300.0) -> List:
    """``fn(rank, *args)`` on ``ranks`` processes of one group; returns
    their results by rank.  ``fn`` and ``args`` are pickled (``fn`` by its
    import path).  ``timeout_s`` bounds each collective; past
    ``deadline_s`` the ranks are killed and the call fails."""
    import torch.multiprocessing as tmp
    backend, cards = placement(ranks, device)
    work = tempfile.mkdtemp(prefix="ranks-")
    threads = max(1, (os.cpu_count() or 1) // ranks) if cards[0] is not None \
        else 1
    try:
        ctx = tmp.start_processes(
            _worker, args=(fn, tuple(args), ranks, backend, cards,
                           os.path.join(work, "store"), work, threads,
                           timeout_s),
            nprocs=ranks, join=False, start_method="spawn")
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=min(5.0, max(0.0, end
                                                    - time.monotonic()))):
                if time.monotonic() >= end:
                    raise RankFailure(f"{ranks} ranks still running after "
                                      f"the {deadline_s:g} s deadline")
        except (tmp.ProcessRaisedException,
                tmp.ProcessExitedException) as err:
            raised = "; ".join(
                f"rank {f.stem[6:]}: {f.read_text().strip().splitlines()[-1]}"
                for f in sorted(Path(work).glob("error-*.txt")))
            raise RankFailure(f"rank {err.error_index} failed ({raised or err})"
                              ) from err
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(work, f"result-{r}.pt"),
                           weights_only=False) for r in range(ranks)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------------------
# The cases
# --------------------------------------------------------------------------


def device_problem(sim, seed: int, device):
    """A problem drawn by torch on ``device`` from ``seed``, under the
    law of ``core.generate`` (the same model, not the same numbers): AR
    blocks by Cholesky factors in fp64, the mean shift on the first ``s``
    coordinates, label flips, an intercept column.  On the card it takes
    milliseconds where numpy takes seconds at full size, and the same
    seed draws the same numbers on every card of one kind.  Returns
    (X (m, n, p + 1), y (m, n)) as fp32 tensors on ``device``."""
    from repro_torch.core import simulate
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    p, s, m, n = sim.p, sim.s, sim.m, sim.n
    N = m * n
    y = 1.0 - 2.0 * (torch.rand(N, generator=g, **f64) < 0.5).double()
    Z = torch.randn(N, p, generator=g, **f64)
    X = torch.empty(N, p + 1, **f64)
    X[:, 0] = 1.0
    for lo, hi in ((0, s), (s, p)):
        if hi > lo:
            cov = torch.tensor(simulate.ar_cov(hi - lo, sim.rho), **f64)
            X[:, 1 + lo:1 + hi] = Z[:, lo:hi] @ torch.linalg.cholesky(cov).T
    X[:, 1:1 + s] += y[:, None] * sim.mu
    flip = torch.rand(N, generator=g, **f64) < sim.p_flip
    y = torch.where(flip, -y, y)
    return X.reshape(m, n, p + 1).float(), y.reshape(m, n).float()


@dataclasses.dataclass(frozen=True)
class Setup:
    """The cases' sizes and tuning, made by the parent (``setup``)."""
    ranks: int                # the group's size
    full: object              # SimConfig of the full-size problem (seed 0)
    design: object            # SimConfig of the design-size problem
    device: str
    grid: tuple               # the full-size lambda grid
    design_grid: tuple
    lam: float                # the fits' lambda and bandwidth at full size
    h: float
    design_h: float


def setup(ranks: int, device: str = "cuda", small: bool = False) -> Setup:
    """The full-size problem — ``SimConfig(p=4095, s=10, m=16, n=1024,
    rho=0.5)`` — with its ``PATH_NUM``-point lambda grid, and the paper's
    design size (10, 200, 101) with a ``DESIGN_NUM``-point one; ``small``
    shrinks the full-size problem to X (16, 64, 64) for the CPU."""
    from repro_torch import core
    full = (core.SimConfig(p=63, s=5, m=16, n=64, rho=0.5) if small else
            core.SimConfig(p=4095, s=10, m=16, n=1024, rho=0.5))
    design = core.SimConfig(p=100, s=10, m=10, n=200)
    X, y = device_problem(full, 0, device)
    Xd, yd, _ = core.generate(design, seed=0)
    return Setup(
        ranks=ranks, full=full, design=design, device=device,
        grid=tuple(core.tuning.lambda_grid(X.cpu().numpy(), y.cpu().numpy(),
                                           num=PATH_NUM).tolist()),
        design_grid=tuple(core.tuning.lambda_grid(Xd, yd,
                                                  num=DESIGN_NUM).tolist()),
        lam=1.2 * math.sqrt(math.log(full.p) / full.n_total),
        h=core.default_bandwidth(full.n_total, full.p),
        design_h=core.default_bandwidth(design.n_total, design.p))


class Problems:
    """The cases' data on ``s.device``: the full-size draw on
    ``erdos_renyi(16, 0.5, seed=0)`` and ``ring(16)``, and the design-size
    problem (``core.generate``, seed 0) on ``erdos_renyi(10, 0.5,
    seed=0)``."""

    def __init__(self, s: Setup):
        from repro_torch import core
        self.X, self.y = device_problem(s.full, 0, s.device)
        self.W = core.graph.erdos_renyi(s.full.m, 0.5, seed=0)
        self.Wring = core.graph.ring(s.full.m)
        Xd, yd, _ = core.generate(s.design, seed=0)
        self.Xd = torch.as_tensor(Xd, device=s.device)
        self.yd = torch.as_tensor(yd, device=s.device)
        self.Wd = core.graph.erdos_renyi(s.design.m, 0.5, seed=0)

    def checksum(self):
        return [float(t.double().sum()) for t in (self.X, self.y)]


def _node_lam(k: int):
    """The (node, lam) mesh shape of ``k`` ranks: k/2 x 2, so that the warm
    path has two lam shards to hand off between (one rank: 1 x 1)."""
    return (k // 2, 2) if k >= 2 else (1, 1)


def _meshes(k: int):
    """The cases' meshes on ``k`` ranks (one rank: every axis 1)."""
    from repro_torch.launch import mesh
    return dict(node=mesh.make_node_mesh(k),
                chunk=mesh.make_node_chunk_mesh(k),
                node_lam=mesh.make_node_lam_mesh(*_node_lam(k)))


def lam_shard_warm(X, y, W, grid, cfg, shards: int, handoff: bool,
                   tol: float = KKT_TOL, check_every: int = CHECK_EVERY,
                   rho=None):
    """The warm path as ``decsvm_path_mesh(mode="warm")`` traverses it on
    ``shards`` lam shards, at one rank (JAX ``decentral.py:655-708``).
    Shard j sweeps its contiguous block of the grid, warm-started while
    lambda decreases and cold at its first cell.  With ``handoff`` a
    second sweep carries the previous shard's last first-sweep (B,
    lambda) into each shard (shard 0 gets (0, 0)): a cell restarts from
    the carried B when lambda decreases, and otherwise resumes its
    first-sweep iterate and round count; the duals restart at 0 either
    way.  ``rho``: the per-node step sizes (default ``compute_rho``).
    Returns the last sweep's (path (L, m, p), iters (L,))."""
    from repro_torch.core import solver
    prob = solver.make_problem(X, y, W, cfg, rho=rho)
    step = solver.make_step(cfg, lambda B: W @ B, W=W)
    kkt = solver.kkt_residual_fn(cfg)
    zero = torch.zeros(X.shape[0], X.shape[2], device=X.device)

    def fit(B0, lam, t0=0):
        state = solver.init_state(prob, B0=B0)._replace(t=torch.tensor(
            t0, dtype=torch.int32, device=X.device))
        f = solver.run_tol(step, prob, float(lam), max_iter=cfg.max_iter,
                           tol=tol, state=state, residual_fn=kkt,
                           check_every=check_every)
        return f.B, int(f.t)

    def sweep(cells, B, lam_prev, first=None):
        out = []
        for i, lam in enumerate(cells):
            cont = lam <= lam_prev
            if first is None or cont:
                B, t = fit(B if cont else zero, lam)
            else:
                B, t = fit(first[i][0], lam, first[i][1])
            lam_prev = lam
            out.append((B, t))
        return out

    blocks = np.split(np.asarray(grid), shards)
    runs = [sweep(cells, zero, math.inf) for cells in blocks]
    if handoff and shards > 1:
        runs = [sweep(cells, runs[j - 1][-1][0] if j else zero,
                      blocks[j - 1][-1] if j else 0.0, runs[j])
                for j, cells in enumerate(blocks)]
    cells = [c for run in runs for c in run]
    return (torch.stack([B for B, _ in cells]),
            torch.tensor([t for _, t in cells], dtype=torch.int32))


def _cases(s: Setup, d: Problems, plain: bool = False) -> Dict[str, Callable]:
    """Each case as a call of the port's entry points on the meshes of
    the group's size (``mesh.device_count()``): the same call at one rank
    outside a group is its reference.  ``plain`` makes the plain
    references: every kernel backend becomes ``"jnp"`` (the plain PyTorch
    update), and each warm path becomes ``lam_shard_warm``, the
    traversal the ranks make, on the lam shards of ``s.ranks``."""
    from repro_torch import core
    from repro_torch.core import decentral as dec
    from repro_torch.launch import mesh

    def cfg(backend, lam=s.lam, h=s.h):
        return core.ADMMConfig(lam=lam, h=h, max_iter=MAX_ITER,
                               backend="jnp" if plain else backend)

    def meshes():
        return _meshes(mesh.device_count())

    def design_raw():
        """The block schedule's raw padded state at the design size."""
        c = cfg("megakernel", lam=0.05, h=s.design_h)
        mc = meshes()["chunk"]
        ops_, offsets, m_pad = dec._chunk_prep(d.Xd, d.yd, d.Wd, c, mc)
        fitted = dec.build_chunked_admm(m_pad, d.Xd.shape[2], c, mc, offsets)
        B, _ = fitted(ops_["X"], ops_["y"], ops_["W_diag"], ops_["W_off"],
                      ops_["deg"], ops_["rho"],
                      torch.ones(d.Xd.shape[2], device=d.Xd.device),
                      ops_["nmask"])
        return B

    def warm(handoff):
        grid = np.asarray(s.design_grid, np.float32)
        c = cfg("megakernel", h=s.design_h)
        if plain:
            W = torch.as_tensor(d.Wd, dtype=torch.float32, device=s.device)
            path, iters = lam_shard_warm(d.Xd, d.yd, W, grid, c,
                                         _node_lam(s.ranks)[1], handoff)
            return dict(path=path, iters=iters)
        return dec.decsvm_path_mesh(
            d.Xd, d.yd, d.Wd, grid, c, mesh=meshes()["node_lam"],
            mode="warm", tol=KKT_TOL, handoff=handoff)._asdict()

    return {
        "fit gather megakernel": lambda: dec.decsvm_fit_sharded(
            d.X, d.y, d.W, cfg("megakernel"), mesh=meshes()["node"]),
        "fit gather pallas": lambda: dec.decsvm_fit_sharded(
            d.X, d.y, d.W, cfg("pallas"), mesh=meshes()["node"]),
        "fit ring megakernel": lambda: dec.decsvm_fit_sharded(
            d.X, d.y, d.Wring, cfg("megakernel"), mesh=meshes()["node"],
            schedule="ring"),
        "fit chunked tol": lambda: dec.decsvm_fit_chunked(
            d.X, d.y, d.W, cfg("megakernel"), mesh=meshes()["chunk"],
            tol=CHUNK_TOL, check_every=CHECK_EVERY),
        "path mesh batched bic": lambda: dec.decsvm_path_mesh(
            d.X, d.y, d.W, np.asarray(s.grid, np.float32),
            cfg("megakernel"), mesh=meshes()["node_lam"])._asdict(),
        "design warm handoff": lambda: warm(True),
        "design warm no handoff": lambda: warm(False),
        "design block ghost rows": design_raw,
    }


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return x


TWO_PASS = ("csvm_block_update", "csvm_local_update")


class LaunchTimer:
    """While active, counts the calls of the wrappers ``ops.<name>`` of
    ``names`` and puts CUDA events around each (a wrapper enqueues nothing
    but its kernel), so ``ms()`` is their device time in a run.  Off the
    card the calls run the plain versions: counted, untimed."""

    def __init__(self, ops, *names):
        self.ops, self.names, self.events, self.orig = ops, names, [], {}
        self.calls = {name: 0 for name in names}

    def __enter__(self):
        for name in self.names:
            self.orig[name] = fn = getattr(self.ops, name)
            setattr(self.ops, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            self.calls[name] += 1
            if not args[0].is_cuda:
                return fn(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def ms(self):
        if not self.events:
            return None
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_case(fn, device) -> dict:
    """One case with the launch and collective counters at 0: its result
    on the host, wall seconds, the two-pass kernels' launches by kernel
    and by instance and their device ms, and the collectives' calls and
    host seconds."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    ops.reset_launches()
    mesh.reset_comm()
    with LaunchTimer(ops, *TWO_PASS) as timer:
        _sync(device)
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        wall = time.perf_counter() - t0
    return dict(result=_host(res), wall_s=wall, kernel_ms=timer.ms(),
                launches={k: ops.launches[k] for k in
                          TWO_PASS + ("csvm_round_block",)},
                instances=dict(ops.two_pass_launches), calls=timer.calls,
                comm_calls=int(mesh.comm["calls"]),
                comm_s=float(mesh.comm["seconds"]))


def rank_cases(rank: int, s: Setup) -> dict:
    """Every case on this rank of the group (``spawn``'s ``fn``)."""
    import torch.distributed as dist
    d = Problems(s)
    out = dict(rank=rank, backend=dist.get_backend(), checksum=d.checksum(),
               cases={})
    for name, fn in _cases(s, d).items():
        out["cases"][name] = run_case(fn, s.device)
    return out


def reference_cases(s: Setup, plain: bool = False) -> dict:
    """Every case at one rank, outside any group, on the same draw: with
    the cases' kernel backends, or with ``plain`` the plain references."""
    d = Problems(s)
    return dict(checksum=d.checksum(), cases={
        name: run_case(fn, s.device)
        for name, fn in _cases(s, d, plain).items()})


# --------------------------------------------------------------------------
# The gates
# --------------------------------------------------------------------------


def _dev(a, b) -> float:
    return float((torch.as_tensor(a).double()
                  - torch.as_tensor(b).double()).abs().max())


def bic_support_weight(N: int, p: int) -> float:
    """The weight of the mean support in the modified BIC
    (``tuning.modified_bic``): sqrt(log N) log p / N."""
    return math.sqrt(math.log(N)) * math.log(p) / N


def support_flips(got, want, cut: float = 1e-8):
    """Coefficients of two paths on opposite sides of the support cut
    |b| > ``cut``: (how many, the largest |b| among them in either path,
    0 if none).  Two fp32 runs of one fit may differ by a flip only where
    |b| lies within their tolerance."""
    g, w = torch.as_tensor(got).abs(), torch.as_tensor(want).abs()
    flip = (g > cut) != (w > cut)
    near = torch.maximum(g, w)[flip]
    return int(flip.sum()), (float(near.max()) if near.numel() else 0.0)


def _same_path(name, got, want, N, p, tol, fail):
    """The dense-bucket gate of fit serving: the path, B and the criterion
    less its support term within ``tol``, the same best lambda, and every
    support flip at |b| <= tol.  Returns (max|dev|, flips)."""
    pen = bic_support_weight(N, p)

    def hinge(r):
        supp = (r["path"].abs() > 1e-8).sum(-1).double().mean(-1)
        return r["criteria"].double() - pen * supp

    dev = max(_dev(got["path"], want["path"]),
              _dev(got["best_B"], want["best_B"]),
              _dev(hinge(got), hinge(want)))
    if not bool(torch.isfinite(got["path"]).all()):
        fail(f"{name}: non-finite path")
    if float(got["best_lam"]) != float(want["best_lam"]):
        fail(f"{name}: best lambda {float(got['best_lam'])} vs "
             f"{float(want['best_lam'])}")
    flips, near = support_flips(got["path"], want["path"])
    if near > tol:
        fail(f"{name}: a support flip at |b| = {near:.3e} > {tol}")
    return dev, flips


def _dev_tree(a, b) -> float:
    if isinstance(a, dict):
        return max(_dev_tree(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(_dev_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return _dev(a, b) if a.numel() else 0.0
    return 0.0 if a == b else math.inf


def check_cases(s: Setup, ranks: List[dict], one: dict, plain: dict,
                log=print) -> dict:
    """Hold every case of every rank to the one-rank run with the same
    kernel backend (``one``) and to the plain references (``plain``), at
    ``TOL`` each; returns the records (launches summed over the ranks by
    kernel and instance, and each case's numbers).  Raises
    ``RankFailure`` on the first gate that fails."""
    def fail(msg):
        raise RankFailure(msg)

    on_card = torch.device(s.device).type == "cuda"
    # the wrappers launch on the card; off it the calls are the count
    counted = "launches" if on_card else "calls"
    k = len(ranks)
    for r in ranks + [plain]:
        if r["checksum"] != one["checksum"]:
            fail(f"rank {r.get('rank', 'plain')}: its draw {r['checksum']} "
                 f"differs from the parent's {one['checksum']}")
    total = {name: 0 for name in TWO_PASS}
    inst = {name: {"stream": 0, "direct": 0} for name in TWO_PASS}
    cases, gaps = {}, {}
    m, n, p = s.full.m, s.full.n, s.full.p + 1
    md = s.design.m
    for name, want in one["cases"].items():
        runs = [r["cases"][name] for r in ranks]
        got = runs[0]["result"]
        for q, run in enumerate(runs[1:], 1):
            if _dev_tree(run["result"], got) != 0.0:
                fail(f"{name}: rank {q}'s result differs from rank 0's")
        for run in runs:
            if run["launches"]["csvm_round_block"]:
                fail(f"{name}: the round kernel ran across ranks")
            if on_card and any(run["launches"][t] != run["calls"][t]
                               for t in TWO_PASS):
                fail(f"{name}: launches {run['launches']} for calls "
                     f"{run['calls']}")
            n2 = sum(run[counted][t] for t in TWO_PASS)
            if n2 == 0:
                fail(f"{name}: no two-pass launch on a rank")
            if on_card and run["instances"] != {"stream": n2, "direct": 0}:
                fail(f"{name}: two-pass instances {run['instances']}, "
                     "expected every launch on the stream instance")
            ran = [t for t in TWO_PASS if run[counted][t]]
            if len(ran) != 1:
                fail(f"{name}: two-pass kernels {ran} on one rank, expected "
                     "one")
            total[ran[0]] += run["launches"][ran[0]]
            for i, c in run["instances"].items():
                inst[ran[0]][i] += c
        launches = runs[0][counted]
        rounds = sum(launches[t] for t in TWO_PASS)
        wantr, base = want["result"], plain["cases"][name]["result"]
        extra = ""
        if name.startswith("fit gather") or name.startswith("fit ring"):
            kern = "csvm_local_update" if "pallas" in name else \
                "csvm_block_update"
            if launches[kern] != MAX_ITER:
                fail(f"{name}: {launches[kern]} {kern} launches a rank, "
                     f"expected {MAX_ITER}")
            dev, pdev = _dev(got, wantr), _dev(got, base)
        elif name == "fit chunked tol":
            (B, t), stops = got, [int(wantr[1]), int(base[1])]
            if not int(t) < MAX_ITER or stops != [int(t)] * 2:
                fail(f"{name}: stopped at round {int(t)}; at one rank "
                     f"{stops[0]}, plain {stops[1]}; expected one round "
                     f"before {MAX_ITER}")
            if launches["csvm_block_update"] != \
                    CHECK_EVERY * math.ceil(int(t) / CHECK_EVERY):
                fail(f"{name}: {launches['csvm_block_update']} launches "
                     f"for {int(t)} rounds")
            dev, pdev = _dev(B, wantr[0]), _dev(B, base[0])
            extra = f", stop round {int(t)} (one rank and plain {stops})"
        elif name == "path mesh batched bic":
            cells = len(s.grid) // _node_lam(k)[1]
            if launches["csvm_block_update"] != cells * MAX_ITER:
                fail(f"{name}: {launches['csvm_block_update']} launches a "
                     f"rank, expected {cells} cells x {MAX_ITER}")
            dev, flips = _same_path(name, got, wantr, m * n, p, TOL, fail)
            pdev, pflips = _same_path(name + " vs plain", got, base, m * n,
                                      p, TOL, fail)
            extra = (f", best lambda {float(got['best_lam']):.6g}, "
                     f"{flips} support flips ({pflips} vs plain)")
        elif name.startswith("design warm"):
            # the one-rank run is the dense warm path; the plain
            # reference makes the ranks' own traversal
            gaps[name] = dev = _dev(got["path"], wantr["path"])
            pdev = _dev(got["path"], base["path"])
            if got["iters"].tolist() != base["iters"].tolist():
                fail(f"{name}: stops {got['iters'].tolist()}, plain "
                     f"{base['iters'].tolist()}")
            if name == "design warm handoff" and float(got["best_lam"]) != \
                    float(wantr["best_lam"]):
                fail(f"{name}: best lambda {float(got['best_lam'])} vs the "
                     f"dense warm path's {float(wantr['best_lam'])}")
            extra = (f", stops {got['iters'].tolist()} (plain the same); "
                     "max|dev| vs one rank is the gap to the dense warm "
                     "path")
        else:                                   # design block ghost rows
            if launches["csvm_block_update"] != MAX_ITER:
                fail(f"{name}: {launches['csvm_block_update']} launches a "
                     f"rank, expected {MAX_ITER}")
            ghost = got[md:]
            if ghost.shape[0] != (-md) % k or bool((ghost != 0).any()):
                fail(f"{name}: ghost rows {tuple(ghost.shape)} not exactly 0")
            dev, pdev = _dev(got[:md], wantr), _dev(got[:md], base[:md])
            extra = f", {ghost.shape[0]} ghost rows exactly 0"
        if not name.startswith("design warm") and dev > TOL:
            fail(f"{name}: max|dev| {dev:.3e} vs one rank > {TOL}")
        if pdev > TOL:
            fail(f"{name}: max|dev| {pdev:.3e} vs plain > {TOL}")
        walls = [run["wall_s"] for run in runs]
        comm_ms = [1e3 * run["comm_s"] / max(1, sum(
            run[counted][t] for t in TWO_PASS)) for run in runs]
        share = max(run["comm_s"] / run["wall_s"] for run in runs)
        kms = [run["kernel_ms"] for run in runs]
        cases[name] = dict(
            kernel=ran[0], wall_s=max(walls), one_rank_wall_s=want["wall_s"],
            plain_wall_s=plain["cases"][name]["wall_s"], kernel_ms=kms,
            launches=launches, instances=runs[0]["instances"],
            comm_ms_per_round=max(comm_ms), comm_share=share,
            comm_calls=runs[0]["comm_calls"], max_abs_dev=dev,
            max_abs_dev_plain=pdev)
        kd = (f"{max(kms):.3f} ms kernel device time a rank (most), "
              if kms[0] is not None else "")
        log(f"ranks {name}: {k} ranks, {ranks[0]['backend']}, wall "
            f"{max(walls):.3f} s (one rank {want['wall_s']:.3f} s), {kd}"
            f"{counted} a rank {json.dumps(launches)}, instances "
            f"{json.dumps(runs[0]['instances'])}, {rounds} rounds; "
            f"collectives {runs[0]['comm_calls']} calls, "
            f"{max(comm_ms):.3f} ms host time a round, {100 * share:.1f}% "
            f"of the wall; max|dev| vs one rank {dev:.3e}, vs plain "
            f"{pdev:.3e}{extra}")
    if not gaps["design warm handoff"] < gaps["design warm no handoff"]:
        fail(f"the hand-off does not bring the warm path closer to the "
             f"dense one: {gaps}")
    return dict(cases=cases, warm_gap=gaps, launches=total, instances=inst)


def run_cases(ranks: int = 4, log=print) -> dict:
    """Build the kernels, run every case on ``ranks`` ranks on the card(s),
    at one rank and plain, and hold them to each other; returns the
    records."""
    from repro_torch.kernels import build
    build.build_all()
    backend, cards = placement(ranks)
    s = setup(ranks)
    t0 = time.perf_counter()
    got = spawn(rank_cases, ranks, (s,), deadline_s=900.0)
    spawn_s = time.perf_counter() - t0
    log(f"ranks: {ranks} ranks on cards {cards}, backend {backend}, X "
        f"{(s.full.m, s.full.n, s.full.p + 1)}: {spawn_s:.1f} s to start the "
        "ranks, run every case and return")
    # the references after the ranks: beside them they share the card
    t0 = time.perf_counter()
    one, plain = reference_cases(s), reference_cases(s, plain=True)
    reference_s = time.perf_counter() - t0
    log(f"ranks references: every case at one rank with the cases' kernels "
        f"and plain, {reference_s:.1f} s")
    records = check_cases(s, got, one, plain, log)
    records.update(backend=backend, ranks=ranks, spawn_s=spawn_s,
                   reference_s=reference_s)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ranks: no CUDA device", file=sys.stderr)
        return 1
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = run_cases(a.ranks, log=lambda *x: print(*x, flush=True))
    print(json.dumps({k: v for k, v in rec.items()
                      if k in ("launches", "instances", "backend", "ranks",
                               "spawn_s", "reference_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
