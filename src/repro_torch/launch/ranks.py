"""Ranks of one ``torch.distributed`` group on one host, and the
decentralized engines and fit serving driven across them.

    python3 -m repro_torch.launch.ranks --ranks 4            # on the card(s)
    python3 -m repro_torch.launch.ranks --fit-serving --ranks 4

``spawn(fn, ranks, args)`` starts ``ranks`` processes (``torch.
multiprocessing``, the spawn start method), joins them in one group and
returns ``fn(rank, *args)`` of each, by rank.  The group's backend follows
where the ranks are placed, never a failure: NCCL when each rank has a
card of its own, gloo when the ranks share card 0 (fewer cards than
ranks) or run on the CPU.  Each rank sets its card before any CUDA work,
so ``device="cuda"`` means its own.  The group meets through a file store
in a fresh temporary directory (no TCP port to contend for).  A rank that
raises, or a run past the deadline, fails the call with ``RankFailure``;
the other ranks are killed.  Each rank's stderr goes to a file of its own,
with ``faulthandler`` on, so that a rank killed by a signal (a C++ abort
in a collective, a segfault) leaves its Python stacks there; the last
lines of the failed rank's file, then the others', end ``RankFailure``'s
message, and every rank's file is copied to the caller's stderr after
the ranks end.

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

Fit serving across the ranks (``--fit-serving``; ``run_fit_serving``):
every rank first makes each exchange the run will use once, untimed
(``warm_exchanges``: NCCL sets up a communicator at its first use), then
rank 0 serves ``fit_requests`` through ``serving.DecsvmFitServer`` — a
full-size chunked request and a dense one by ``run()``, two design-size
chunked requests through the worker — while the other ranks follow
(``serve_requests``); each bucket is recorded on each rank
(``BucketRecorder``).  The parent serves the same requests at one rank,
with the same kernels and plain, and holds rank 0's results to both and
every follower's to rank 0's, bit for bit (``check_fit_serving``).
``chip_smoke.py`` runs it as its phase 21 on the first points of the grid.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import faulthandler
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
# lines of each rank's stderr that end a RankFailure's message
STDERR_TAIL = 40


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
    # this rank's stderr (Python's, C++'s, and faulthandler's stacks of
    # every thread on a fatal signal) into a file the parent reads
    err = os.open(os.path.join(out_dir, f"stderr-{rank}.txt"),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(err, 2)
    os.close(err)
    faulthandler.enable(all_threads=True)
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


def _stderr_tails(work: str, first: Optional[int] = None) -> str:
    """The last STDERR_TAIL lines of each rank's stderr that holds any,
    rank ``first``'s first, for a RankFailure's message."""
    files = sorted(Path(work).glob("stderr-*.txt"),
                   key=lambda f: (int(f.stem[7:]) != first, int(f.stem[7:])))
    tails = []
    for f in files:
        lines = f.read_text(errors="replace").rstrip().splitlines()
        if lines:
            tails.append(f"\n--- stderr of rank {f.stem[7:]}, last "
                         f"{min(len(lines), STDERR_TAIL)} of {len(lines)} "
                         "lines ---\n" + "\n".join(lines[-STDERR_TAIL:]))
    return "".join(tails)


def _forward_stderr(work: str) -> None:
    """Every rank's stderr file to this process's stderr, each line
    marked with its rank."""
    for f in sorted(Path(work).glob("stderr-*.txt"),
                    key=lambda f: int(f.stem[7:])):
        for line in f.read_text(errors="replace").splitlines():
            print(f"[rank {f.stem[7:]}] {line}", file=sys.stderr)
    sys.stderr.flush()


def spawn(fn: Callable, ranks: int, args=(), *, device: str = "cuda",
          deadline_s: float = 600.0, timeout_s: float = 300.0) -> List:
    """``fn(rank, *args)`` on ``ranks`` processes of one group; returns
    their results by rank.  ``fn`` and ``args`` are pickled (``fn`` by its
    import path).  ``timeout_s`` bounds each collective; past
    ``deadline_s`` the ranks are killed and the call fails.  A failure's
    message ends with the tails of the ranks' stderr (``_stderr_tails``)."""
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
                                      f"the {deadline_s:g} s deadline"
                                      + _stderr_tails(work))
        except (tmp.ProcessRaisedException,
                tmp.ProcessExitedException) as err:
            why = [f"rank {f.stem[6:]}: "
                   f"{f.read_text().strip().splitlines()[-1]}"
                   for f in sorted(Path(work).glob("error-*.txt"))]
            if isinstance(err, tmp.ProcessExitedException):
                why.insert(0, str(err))   # the signal or exit code
            raise RankFailure(f"rank {err.error_index} failed "
                              f"({'; '.join(why) or err})"
                              + _stderr_tails(work, err.error_index)
                              ) from err
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
            _forward_stderr(work)
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


# --------------------------------------------------------------------------
# Fit serving across the ranks
# --------------------------------------------------------------------------

# the full-size draws (seeds 0, 1, ...) over which chip_smoke.py's fit
# serving (phase 4c) makes its shared grid; the warm request's grid points:
# an odd count, which no "lam" axis of 2 or 4 divides, so its (node_chunk,
# lam) mesh is (ranks, 1) and the ranks traverse its path as one rank does
# (a "lam" axis would hand the path off between shards: another traversal)
SERVE_DRAWS = 4
WARM_NUM = 5
SERVE_KERNELS = TWO_PASS + ("csvm_round_block",)


def fit_serving_setup(ranks: int, num: int = PATH_NUM, device: str = "cuda",
                      small: bool = False) -> Setup:
    """``setup``'s sizes with the grid of ``chip_smoke.py``'s fit serving
    (phase 4c): ``shared_lambda_grid`` of ``PATH_NUM`` points over the
    full-size draws of seeds 0 .. ``SERVE_DRAWS`` - 1, its first ``num``.
    Here problem 0 is ``device_problem``'s draw, as the ranks draw it
    (phase 4c's is ``core.generate``'s)."""
    from repro_torch import core
    s = setup(ranks, device, small)
    draws = [device_problem(s.full, seed, device)
             for seed in range(SERVE_DRAWS)]
    grid = core.tuning.shared_lambda_grid(
        np.stack([X.cpu().numpy() for X, _ in draws]),
        np.stack([y.cpu().numpy() for _, y in draws]), num=PATH_NUM)
    return dataclasses.replace(s, grid=tuple(grid[:num].tolist()))


def fit_requests(s: Setup, backend: str):
    """The requests of fit serving across ``s.ranks`` ranks, as (drained
    by ``run()``, given to the worker), each of ``MAX_ITER`` rounds under
    ``backend``:

    - rid 0: the full-size problem (``device_problem``, seed 0) on
      ``erdos_renyi(16, 0.5, seed=0)`` over ``s.grid``, batched: m > the
      ranks, so ``engine="auto"`` makes it chunked;
    - rid 1: the design-size problem's first ``s.ranks`` nodes on a ring,
      over ``s.design_grid``, batched: m <= the ranks, so dense;
    - rid 2: the design-size problem on ``erdos_renyi(10, 0.5, seed=0)``,
      warm with the KKT stop at ``CHUNK_TOL`` (at 1e-3 four of its five
      points run all ``MAX_ITER`` rounds) over ``lambda_grid`` of
      ``WARM_NUM`` points, resolved at submit;
    - rid 3: the same problem with SCAD LLA and the Theorem-4 threshold
      over ``s.design_grid``, batched.
    """
    from repro_torch import core
    from repro_torch.serving import FitRequest

    def cfg(h):
        return core.ADMMConfig(lam=0.0, h=h, max_iter=MAX_ITER,
                               backend=backend)
    X, y = device_problem(s.full, 0, s.device)
    Xd, yd, _ = core.generate(s.design, seed=0)
    k = s.ranks
    design = dict(X=Xd, y=yd, W=core.graph.erdos_renyi(s.design.m, 0.5,
                                                       seed=0),
                  cfg=cfg(s.design_h))
    sync = [FitRequest(rid=0, X=X, y=y,
                       W=core.graph.erdos_renyi(s.full.m, 0.5, seed=0),
                       cfg=cfg(s.h), lams=s.grid, mode="batched"),
            FitRequest(rid=1, X=Xd[:k], y=yd[:k], W=core.graph.ring(k),
                       cfg=cfg(s.design_h), lams=s.design_grid,
                       mode="batched")]
    later = [FitRequest(rid=2, **design, num=WARM_NUM, mode="warm",
                        tol=CHUNK_TOL),
             FitRequest(rid=3, **design, lams=s.design_grid, mode="batched",
                        penalty="scad", threshold=True)]
    return sync, later


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class BucketRecorder:
    """While active, each bucket that a ``DecsvmFitServer`` of this
    process runs, on any thread, leaves a record in ``buckets``: its
    engine, its rids, its wall seconds (the card synchronized around it),
    the CSVM kernels' calls and their launches by kernel and by instance
    and device ms (``LaunchTimer``), and the collectives' calls, host
    seconds and bytes by op inside it; ``paths`` holds each request's
    lambda path and stops (the ``PathResult`` of
    ``tuning.select_lambda_path`` or ``select_lambda_path_many``), by
    rid.  A chunked bucket's broadcast and agreement lie outside it."""

    def __init__(self, device):
        self.device = device
        self.buckets: List[dict] = []
        self.paths: Dict[int, tuple] = {}
        self._found: List[tuple] = []

    def __enter__(self):
        from repro_torch.core import tuning
        from repro_torch.kernels import ops
        from repro_torch.serving import fit
        server = fit.DecsvmFitServer
        self.timer = LaunchTimer(ops, *SERVE_KERNELS).__enter__()
        self._orig = [(owner, name, getattr(owner, name)) for owner, name in (
            (server, "_run_bucket_dense"), (server, "_run_bucket_chunked"),
            (tuning, "select_lambda_path"), (tuning, "select_lambda_path_many"))]
        for owner, name, fn in self._orig:
            setattr(owner, name, self._bucket(name.rsplit("_", 1)[1], fn)
                    if owner is server else self._path(fn, name.endswith("many")))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)
        self.timer.__exit__(*exc)

    def _path(self, fn, many: bool):
        def kept(*args, **kw):
            out = fn(*args, **kw)
            res = out[3]
            self._found += (list(zip(res.path, res.iters)) if many
                            else [(res.path, res.iters)])
            return out
        return kept

    def _bucket(self, engine: str, fn):
        from repro_torch.kernels import ops
        from repro_torch.launch import mesh
        timer = self.timer

        def counters():
            return (dict(timer.calls), dict(ops.launches),
                    dict(ops.two_pass_launches),
                    dict(ops.round_block_launches), dict(mesh.comm),
                    dict(mesh.comm_bytes))

        def recorded(srv, reqs, lams):
            before, e0, f0 = counters(), len(timer.events), len(self._found)
            _sync(self.device)
            t0 = time.perf_counter()
            out = fn(srv, reqs, lams)
            _sync(self.device)
            wall = time.perf_counter() - t0
            calls, launches, two_pass, rounds, comm, nbytes = (
                _diff(a, b) for a, b in zip(counters(), before))
            events = timer.events[e0:]
            self.buckets.append(dict(
                engine=engine, rids=[r.rid for r in reqs], wall_s=wall,
                calls=calls, launches={k: launches.get(k, 0)
                                       for k in SERVE_KERNELS},
                two_pass_instances=two_pass, round_instances=rounds,
                kernel_ms=(sum(a.elapsed_time(b) for a, b in events)
                           if events else None),
                comm_calls=int(comm.get("calls", 0)),
                comm_s=float(comm.get("seconds", 0.0)), comm_bytes=nbytes))
            for req, (path, iters) in zip(reqs, self._found[f0:]):
                self.paths[req.rid] = (_host(path), _host(iters))
            return out
        return recorded


def serve_requests(sync, later, device, timeout_s: float = 900.0) -> dict:
    """One ``DecsvmFitServer`` on ``device``: at one rank outside a group,
    or as rank 0 of one, ``sync`` through ``run()`` and then ``later``
    through the worker (``start``, ``FitHandle.result``, ``stop``); on
    another rank of a group, ``follow()`` (the requests are rank 0's).
    The launch and collective counters are set to 0 just before, the
    buckets recorded (``BucketRecorder``) and the collectives timed
    (``mesh.time_collectives``).  Returns this rank's results by rid, its
    bucket log's keys, the buckets and paths, its wall, its collectives'
    calls, host seconds, bytes and ms by op, and its peak device memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.serving import fit
    on_card = torch.device(device).type == "cuda"
    srv = fit.DecsvmFitServer(device=device)
    ops.reset_launches()
    mesh.reset_comm()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with BucketRecorder(device) as rec, mesh.time_collectives():
        _sync(device)
        t0 = time.perf_counter()
        if mesh.rank() == 0:
            for req in sync:
                srv.submit(req)
            results = srv.run()
            srv.start()
            try:
                handles = [srv.submit(req) for req in later]
                results.update((h.rid, h.result(timeout_s)) for h in handles)
            finally:
                srv.stop()
        else:
            results = srv.follow()
        _sync(device)
        wall = time.perf_counter() - t0
    return dict(results=results, keys=[key for key, _ in srv.bucket_log],
                buckets=rec.buckets, paths=rec.paths, wall_s=wall,
                comm_calls=int(mesh.comm["calls"]),
                comm_s=float(mesh.comm["seconds"]),
                comm_bytes=dict(mesh.comm_bytes),
                collective_ms=mesh.collective_ms(by_op=True),
                broadcast_ms=mesh.span_ms("broadcast"),
                peak_bytes=(torch.cuda.max_memory_allocated() if on_card
                            else None))


def warm_exchanges(s: Setup) -> Dict[str, float]:
    """Each exchange of fit serving across the group once, before the
    timed run: the whole group's (a broadcast and an agreement), then
    every line of each mesh the chunked buckets of ``fit_requests`` bind
    (the (node_chunk, lam) mesh each path picks, the node_chunk mesh of
    the LLA re-fit).  Returns the seconds of each, by mesh; the counters
    are set to 0 after."""
    from repro_torch.core import decentral as dec
    from repro_torch.launch import mesh
    k = mesh.device_count()
    t0 = time.perf_counter()
    mesh.broadcast_from(0, None, [torch.zeros(1, device=s.device)]
                        if mesh.rank() == 0 else ())
    mesh.same_on_every_rank(0)
    _sync(s.device)
    out = {"group": time.perf_counter() - t0}
    meshes = [mesh.make_node_chunk_mesh()] + [
        mesh.make_chunk_lam_mesh(*dec._choose_mesh_shape(m, C, k,
                                                         chunked=True))
        for m, C in ((s.full.m, len(s.grid)), (s.design.m, WARM_NUM),
                     (s.design.m, len(s.design_grid)))]
    for m in dict.fromkeys(meshes):
        out[json.dumps(m.shape)] = mesh.warm(m)
    mesh.reset_comm()
    return out


def rank_fit_serving(rank: int, s: Setup) -> dict:
    """``spawn``'s ``fn``: the exchanges warmed, then rank 0 serves
    ``fit_requests`` under ``megakernel`` and the other ranks follow."""
    import torch.distributed as dist
    warm = warm_exchanges(s)
    reqs = fit_requests(s, "megakernel") if rank == 0 else ((), ())
    out = serve_requests(*reqs, s.device)
    out.update(rank=rank, backend=dist.get_backend(), warm_s=warm)
    return out


def fit_terms(got, want, N: int, p: int) -> Dict[str, float]:
    """The max |dev| of each term ``_same_fit`` holds of two
    ``FitResult``s of one request: B, beta, the criterion less its support
    term (BIC) over the table, and the LLA weights where the request has
    them."""
    tg, tw = np.array(got.table), np.array(want.table)
    pen = bic_support_weight(N, p) if got.criterion == "bic" else 0.0
    out = {"B": float(np.abs(got.B - want.B).max()),
           "beta": float(np.abs(got.beta - want.beta).max()),
           "criterion": float(np.abs((tg[:, 1] - pen * tg[:, 2])
                                     - (tw[:, 1] - pen * tw[:, 2])).max())}
    if want.lam_weights is not None:
        out["lam_weights"] = float(np.abs(got.lam_weights
                                          - want.lam_weights).max())
    return out


def _same_fit(name, got, want, paths, N, p, tol, fail):
    """A ``FitResult`` against another run's of the same request, as
    ``chip_smoke.py``'s fit serving holds them: the same best lambda and
    table lambdas, the same stops; B, beta, the LLA weights and the
    criterion less its support term (BIC) within ``tol``; every support
    flip of the two paths (``paths``: each run's (path, iters)) at |b| <=
    ``tol``; the table's support column its path's.  Returns (max|dev|,
    flips)."""
    (pg, ig), (pw, iw) = paths
    if not bool(np.isfinite(got.B).all()):
        fail(f"{name}: non-finite B")
    if got.best_lam != want.best_lam:
        fail(f"{name}: best lambda {got.best_lam} vs {want.best_lam}")
    tg, tw = np.array(got.table), np.array(want.table)
    if not np.array_equal(tg[:, 0], tw[:, 0]):
        fail(f"{name}: the table's lambdas differ")
    if ig.tolist() != iw.tolist():
        fail(f"{name}: stops {ig.tolist()} vs {iw.tolist()}")
    dev = max(fit_terms(got, want, N, p).values())
    flips, near = support_flips(pg, pw)
    if near > tol:
        fail(f"{name}: a support flip at |b| = {near:.3e} > {tol}")
    support = (pg.abs() > 1e-8).sum(-1).double().mean(-1).numpy()
    if not np.array_equal(support, tg[:, 2]):
        fail(f"{name}: the table's support is not its path's")
    if dev > tol:
        fail(f"{name}: max|dev| {dev:.3e} > {tol}")
    return dev, flips


def _identical(a, b) -> bool:
    """Two ``FitResult``s equal bit for bit (their bucket walls aside)."""
    if type(a) is not type(b):
        return False
    fa, fb = (dataclasses.asdict(x) for x in (a, b))
    return all(k == "wall_s" or (np.array_equal(fa[k], fb[k])
                                 if isinstance(fa[k], np.ndarray)
                                 else fa[k] == fb[k]) for k in fa)


# the buckets of fit_requests in the group: run() drains rid 0 (chunked)
# and rid 1 (dense); the worker takes rid 2, then rid 3 (two keys)
SERVE_BUCKETS = (("chunked", [0]), ("dense", [1]), ("chunked", [2]),
                 ("chunked", [3]))


def request_sizes(s: Setup, k: int) -> Dict[int, tuple]:
    """{rid: (N, p)} of ``fit_requests`` across ``k`` ranks, as their
    criteria count samples and features (the dense request's m = k
    nodes)."""
    out = {}
    for rid, sim in {0: s.full, 1: s.design, 2: s.design,
                     3: s.design}.items():
        out[rid] = (k * sim.n if rid == 1 else sim.m * sim.n, sim.p + 1)
    return out


def check_fit_serving(s: Setup, ranks: List[dict], one: dict, plain: dict,
                      log=print) -> dict:
    """Hold fit serving across the ranks to one rank: rank 0's buckets
    as ``SERVE_BUCKETS`` (the same keys on every follower, which ran the
    chunked ones only and rank 0's dense bucket not at all: no collective
    in it); each follower's results equal rank 0's bit for bit; every
    result of rank 0 against the same request at one rank with the same
    kernels (``one``) and plain (``plain``), at ``TOL`` (``_same_fit``);
    the full-size request's two-pass launches a rank its cells on the
    rank's lam shard times ``MAX_ITER``, the dense bucket's round launches
    one a grid point; on the card every launch on the stream instance.
    Returns the records; raises ``RankFailure`` on the first gate that
    fails."""
    from repro_torch.core import decentral as dec

    def fail(msg):
        raise RankFailure(f"fit serving: {msg}")

    on_card = torch.device(s.device).type == "cuda"
    counted = "launches" if on_card else "calls"
    k, r0 = len(ranks), ranks[0]
    got = [(b["engine"], b["rids"]) for b in r0["buckets"]]
    if got != list(SERVE_BUCKETS):
        fail(f"rank 0's buckets {got}, expected {list(SERVE_BUCKETS)}")
    tags = [key[-1] for key in r0["keys"]]
    if tags != [e for e, _ in SERVE_BUCKETS]:
        fail(f"rank 0's bucket log tags {tags}")
    chunked_keys = [key for key in r0["keys"] if key[-1] == "chunked"]
    chunked_rids = [r for e, rids in SERVE_BUCKETS if e == "chunked"
                    for r in rids]
    for q, f in enumerate(ranks[1:], 1):
        if f["keys"] != chunked_keys or [b["engine"] for b in f["buckets"]] \
                != ["chunked"] * len(chunked_keys):
            fail(f"rank {q} ran buckets {[b['rids'] for b in f['buckets']]}"
                 f" of keys {f['keys']}, expected rank 0's chunked ones")
        if sorted(f["results"]) != sorted(chunked_rids):
            fail(f"rank {q}'s results {sorted(f['results'])}")
        for rid in chunked_rids:
            if not _identical(f["results"][rid], r0["results"][rid]):
                fail(f"rid {rid}: rank {q}'s result differs from rank 0's")
    dense = r0["buckets"][1]
    if dense["comm_calls"] or dense["comm_bytes"]:
        fail(f"the dense bucket issued collectives: {dense['comm_calls']} "
             f"calls, bytes {dense['comm_bytes']}")
    nl = dec._choose_mesh_shape(s.full.m, len(s.grid), k, chunked=True)[1]
    totals = {name: 0 for name in SERVE_KERNELS}
    instances = {"two_pass": {"stream": 0, "direct": 0},
                 "round": {"stream": 0, "direct": 0}}
    for r in ranks:
        for b in r["buckets"]:
            n2 = sum(b[counted].get(t, 0) for t in TWO_PASS)
            nr = b[counted].get("csvm_round_block", 0)
            if b["engine"] == "chunked" and (nr or not n2):
                fail(f"rank {r['rank']} rids {b['rids']}: {counted} "
                     f"{b[counted]}, expected two-pass launches only")
            if on_card and (b["two_pass_instances"].get("direct")
                            or b["round_instances"].get("direct")):
                fail(f"rank {r['rank']} rids {b['rids']}: instances "
                     f"{b['two_pass_instances']} {b['round_instances']}, "
                     "expected every launch on the stream instance")
            for name in SERVE_KERNELS:
                totals[name] += b["launches"][name]
            for i in ("stream", "direct"):
                instances["two_pass"][i] += b["two_pass_instances"].get(i, 0)
                instances["round"][i] += b["round_instances"].get(i, 0)
        full = r["buckets"][0]
        want_n = len(s.grid) // nl * MAX_ITER
        if full[counted].get("csvm_block_update", 0) != want_n:
            fail(f"rank {r['rank']}: {full[counted]} for the full-size "
                 f"request, expected {want_n} csvm_block_update "
                 f"({len(s.grid) // nl} cells x {MAX_ITER})")
    if dense[counted].get("csvm_round_block", 0) != len(s.design_grid):
        fail(f"the dense bucket: {dense[counted]}, expected "
             f"{len(s.design_grid)} csvm_round_block")
    fits = {}
    for rid, (N, p) in request_sizes(s, k).items():
        g = r0["results"][rid]
        dev, flips = _same_fit(f"rid {rid} vs one rank", g,
                               one["results"][rid],
                               (r0["paths"][rid], one["paths"][rid]), N, p,
                               TOL, fail)
        pdev, pflips = _same_fit(f"rid {rid} vs plain", g,
                                 plain["results"][rid],
                                 (r0["paths"][rid], plain["paths"][rid]), N,
                                 p, TOL, fail)
        fits[rid] = dict(max_abs_dev=dev, max_abs_dev_plain=pdev,
                         flips=flips, flips_plain=pflips,
                         best_lam=g.best_lam,
                         stops=r0["paths"][rid][1].tolist())
    recs, ci = [], 0
    for i, (engine, rids) in enumerate(SERVE_BUCKETS):
        runs = [r0["buckets"][i]]              # rank 0's, then the followers'
        if engine == "chunked":
            runs += [f["buckets"][ci] for f in ranks[1:]]
            ci += 1
        rounds = [max(1, sum(b[counted].get(t, 0) for t in TWO_PASS))
                  for b in runs]
        recs.append(dict(
            engine=engine, rids=rids,
            wall_s=[b["wall_s"] for b in runs],
            one_rank_wall_s=one["buckets"][i]["wall_s"],
            plain_wall_s=plain["buckets"][i]["wall_s"],
            launches=[b[counted] for b in runs],
            instances=[(b["two_pass_instances"], b["round_instances"])
                       for b in runs],
            kernel_ms=[b["kernel_ms"] for b in runs],
            comm_ms_per_round=[1e3 * b["comm_s"] / n
                               for b, n in zip(runs, rounds)],
            comm_bytes=[b["comm_bytes"] for b in runs],
            fits={rid: fits[rid] for rid in rids}))
        rec = recs[-1]
        log(f"fitserve-ranks rids {rids} {engine}: wall "
            f"{json.dumps([round(w, 4) for w in rec['wall_s']])} s a rank "
            f"(one rank {rec['one_rank_wall_s']:.4f}, plain "
            f"{rec['plain_wall_s']:.4f}); {counted} a rank "
            f"{json.dumps(rec['launches'])}, instances "
            f"{json.dumps(rec['instances'])}; collectives "
            f"{json.dumps([round(c, 4) for c in rec['comm_ms_per_round']])} "
            f"host ms a round, bytes {json.dumps(rec['comm_bytes'])}; "
            + "; ".join(f"rid {rid}: best lambda {f['best_lam']:.6g}, stops "
                        f"{f['stops']}, max|dev| vs one rank "
                        f"{f['max_abs_dev']:.3e} ({f['flips']} support "
                        f"flips), vs plain {f['max_abs_dev_plain']:.3e}"
                        for rid, f in rec["fits"].items()))
    # a follower's broadcast spans also hold its wait for rank 0
    broadcast = [dict(bytes=r["comm_bytes"].get("broadcast", 0),
                      ms=r["broadcast_ms"], peak_bytes=r["peak_bytes"],
                      warm_s=r["warm_s"], wall_s=r["wall_s"])
                 for r in ranks]
    for r, b in zip(ranks, broadcast):
        log(f"fitserve-ranks rank {r['rank']} ({r['backend']}): the "
            f"broadcasts {b['bytes'] / 2**20:.2f} MiB, "
            f"{json.dumps([round(t, 3) for t in b['ms']])} ms (the "
            f"buckets', then the stop; on a follower its wait for rank 0 "
            f"too); the first exchanges (untimed) "
            f"{json.dumps({m: round(t, 4) for m, t in b['warm_s'].items()})}"
            f" s; wall {b['wall_s']:.3f} s, peak "
            + (f"{b['peak_bytes'] / 1e9:.2f} GB" if b["peak_bytes"] is not None
               else "(no card)"))
    return dict(buckets=recs, ranks=broadcast, launches=totals,
                instances=instances)


def run_fit_serving(ranks: int = 4, log=print, num: int = PATH_NUM,
                    device: str = "cuda", small: bool = False) -> dict:
    """Build the kernels, serve ``fit_requests`` (on ``num`` points of the
    grid) across ``ranks`` ranks placed by ``placement``, then the same
    requests at one rank with the same kernels and plain, and hold them to
    each other (``check_fit_serving``); returns the records."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all(("csvm_update",))      # the path's only source
    backend, cards = placement(ranks, device)
    t0 = time.perf_counter()
    s = fit_serving_setup(ranks, num, device, small)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = spawn(rank_fit_serving, ranks, (s,), device=device,
                deadline_s=900.0)
    spawn_s = time.perf_counter() - t0
    log(f"fitserve-ranks: {ranks} ranks on cards {cards}, backend {backend},"
        f" X {(s.full.m, s.full.n, s.full.p + 1)}, {len(s.grid)} grid "
        f"points: set-up {setup_s:.1f} s, {spawn_s:.1f} s to start the "
        "ranks, serve and return")
    t0 = time.perf_counter()
    one = serve_requests(*fit_requests(s, "megakernel"), device)
    plain = serve_requests(*fit_requests(s, "jnp"), device)
    reference_s = time.perf_counter() - t0
    log(f"fitserve-ranks references: the requests at one rank with the "
        f"kernels and plain, {reference_s:.1f} s")
    records = check_fit_serving(s, got, one, plain, log)
    records.update(backend=backend, ranks_n=ranks, cards=cards,
                   spawn_s=spawn_s, reference_s=reference_s,
                   grid=list(s.grid))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--fit-serving", action="store_true",
                    help="fit serving across the ranks (run_fit_serving) "
                         "in place of the engine cases")
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
    say = lambda *x: print(*x, flush=True)  # noqa: E731
    if a.fit_serving:
        rec = run_fit_serving(a.ranks, log=say)
        keys = ("launches", "instances", "backend", "ranks_n", "spawn_s",
                "reference_s", "buckets", "ranks")
    else:
        rec = run_cases(a.ranks, log=say)
        keys = ("launches", "instances", "backend", "ranks", "spawn_s",
                "reference_s")
    print(json.dumps({k: v for k, v in rec.items() if k in keys},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
