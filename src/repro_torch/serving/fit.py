"""Fit-serving endpoint in torch: tuned deCSVM fits as batched, async
infrastructure on the card.

Counterpart of ``repro.serving.fit``.  A queue of fit requests (features +
labels + network adjacency), each answered with a lambda-tuned,
optionally folded-concave (LLA) deCSVM head.  ``submit()`` returns a
future-like ``FitHandle`` at once; the scheduler groups queued requests
into buckets keyed by (shapes, config, grid, criterion, mode, penalty,
..., engine), and each bucket of up to ``max_batch`` same-key problems
resolves in one call:

- **dense** buckets stack the problems on the card once and run
  ``tuning.select_lambda_path_many`` (scoring and the per-problem argmin
  included) and, for a penalty, the LLA stage-2 re-fit
  ``path.decsvm_fit_many`` — under a megakernel backend one round-kernel
  launch a grid point and problem, and one a re-fit;
- **chunked** buckets (``engine="auto"`` when the network has more nodes
  than ranks: on one card, every network of more than one node) run each
  request through ``tuning.select_lambda_path(engine="chunked")`` — the
  (node_chunk, lam) mesh engine of ``repro_torch.core.decentral`` — and
  its stage 2 through ``decentral.decsvm_path_chunked``; every round
  there is one two-pass kernel launch.

Inside a ``torch.distributed`` group (``launch.ranks.spawn`` starts one)
every rank makes a server with the same arguments.  Rank 0 is the front
end, as JAX's single controller is: only it takes ``submit()``, resolves
``lams=None`` grids, forms buckets and delivers results; the other ranks
call ``follow()``, which returns when rank 0 calls ``stop()``.  Before
each chunked bucket rank 0 broadcasts the bucket — its key, its resolved
grid, its requests with their X and y as tensors
(``launch.mesh.broadcast_from``) — and every rank then runs the same
``_run_bucket_chunked`` on the same inputs, so the engine calls and their
collectives cannot diverge; after it the ranks agree on its outcome
(``launch.mesh.same_on_every_rank``).  A bucket that raises the same
error on every rank is delivered to rank 0's handles and the ranks go on
serving; a bucket whose outcome differs between ranks raises
``RanksDiverged`` on every rank, so that the group's call fails and rank
0 never hands out a result that some rank did not reach.  A dense bucket
runs on rank 0 alone, as JAX's dense program runs on one device: the
followers are not told of it and it issues no collective.  The buckets of
rank 0 run one at a time (a lock around ``step``), in the order of its
broadcasts.

The server shares the ``FifoEngine`` surface with the token engine
(submit / step / run / pending / utilization) and adds an async mode:
``start()`` spawns a worker thread that drains the queue as buckets (and
issues their CUDA work); ``FitHandle.result()`` blocks until its request
resolves.  Results are delivered exactly once — ``run()`` returns (and
drops) the results completed since the last drain, and a ``FitHandle``
hands its result out independently.  Submitting a request id that is
still pending or undelivered raises.  Every handle update happens under
the server's lock.

A ``FitRequest`` may carry ``rho`` (m,) and ``cv_rho`` (k, m), the
per-node step sizes of its full-data and fold fits; without them the
engines compute ``compute_rho`` on the card.  ``DecsvmFitServer(device=)``
defaults to the card and raises without one; pass ``device="cpu"`` to
run the plain path on the CPU.  ``FitResult`` keeps JAX's host types.

With ``repro_torch.spans`` on, the server records where its host time
goes, on the profiler's clock: each request's wait from ``submit()`` to
its bucket's start (``serve.queue``, with its ``rid`` and ``bucket``),
each bucket from its start to its last handle set (``serve.bucket``: a
per-server ``bucket`` count, ``size``, ``engine``), and inside a dense
bucket the stack (``serve.stack``), the margins and the copy back
(``serve.margins``) and the delivery (``serve.deliver``), around the
path's own spans (``core.path``, ``core.tuning``, ``core.solver``).  To
read them: ``spans.enable(True)``, serve, ``spans.take()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import metrics, solver, tuning
from repro_torch.core.admm import (ADMMConfig, as_f32, hard_threshold_final,
                                   resolve_device)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.serving.engine import FifoEngine


@dataclasses.dataclass
class FitRequest:
    """One decentralized fit job.

    X: (m, n, p) node-partitioned design (include the intercept column);
    y: (m, n) labels in {-1, +1}; W: (m, m) adjacency — or a
    ``graph.BlockTopology`` for chunked fits.
    lams: explicit lambda grid, or None to build ``lambda_grid(num)`` from
    this request's data at submit time (requests share a bucket only when
    their resolved grids coincide).
    criterion: "bic" | "cv"; penalty: None (plain l1) or one of
    ``repro_torch.core.penalties.PENALTIES`` for a one-step-LLA stage-2
    re-fit.  engine: "auto" | "dense" | "chunked"; "auto" resolves at
    submit time to "chunked" when m exceeds ``launch.mesh.device_count()``,
    else "dense", and the resolved engine is part of the bucket key.
    rho / cv_rho: optional (m,) / (k, m) step sizes (default: computed).
    """
    rid: int
    X: np.ndarray
    y: np.ndarray
    W: np.ndarray
    cfg: ADMMConfig = ADMMConfig(lam=0.0)
    lams: Optional[Sequence[float]] = None
    num: int = 12
    mode: str = "warm"
    criterion: str = "bic"
    cv_folds: int = 5
    cv_seed: int = 0
    penalty: Optional[str] = None
    threshold: bool = False          # Theorem-4 hard thresholding of B
    tol: float = 1e-6
    stop_rule: str = "kkt"
    check_every: int = 4
    engine: str = "auto"
    rho: Optional[np.ndarray] = None
    cv_rho: Optional[np.ndarray] = None


@dataclasses.dataclass
class FitResult:
    rid: int
    best_lam: float
    B: np.ndarray                    # (m, p) per-node estimates
    beta: np.ndarray                 # (p,) network-average estimate
    table: List[Tuple[float, float, float]]   # (lambda, criterion, supp)
    criterion: str
    lam_weights: Optional[np.ndarray]         # LLA stage-2 weights, if any
    train_accuracy: float
    consensus_gap: float
    wall_s: float                    # wall-clock of the bucket that ran it
    batch_size: int = 1              # problems co-batched in that bucket


class FitHandle:
    """Future-like handle for a submitted ``FitRequest``.

    ``done()`` polls; ``result(timeout)`` blocks until the request
    resolves (driving the server inline when no background worker is
    running) and returns the ``FitResult``.  A bucket failure surfaces
    here as the raised exception.
    """

    def __init__(self, rid: int, server: "DecsvmFitServer") -> None:
        self.rid = rid
        self._server = server
        self._event = threading.Event()
        self._result: Optional[FitResult] = None
        self._error: Optional[BaseException] = None
        self._queued_ns: Optional[int] = None   # stamped while spans are on

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> FitResult:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        if not self._event.is_set():
            self._server._drive(self, timeout)
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        if not self._event.wait(remaining):
            raise TimeoutError(f"fit request {self.rid} not done "
                               f"within {timeout}s")
        if self._error is not None:
            raise self._error
        self._server._mark_delivered(self.rid)
        return self._result

    # called by the server, under its lock
    def _set(self, result: Optional[FitResult],
             error: Optional[BaseException] = None) -> None:
        self._result, self._error = result, error
        self._event.set()


_host = tuning._host


def _shape(a) -> tuple:
    """The shape of an array or a tensor on any device."""
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


class RanksDiverged(RuntimeError):
    """The ranks of a group disagree on a chunked bucket's outcome: some
    raised and some did not, or they raised different errors."""


def _outcome(error: Optional[BaseException]) -> int:
    """0 for a bucket that ran, else a code of the error's type and text
    (the same on every rank for the same error)."""
    if error is None:
        return 0
    return 1 + zlib.crc32(f"{type(error).__name__}: {error}".encode())


def _stub(req: FitRequest) -> FitRequest:
    """``req`` as broadcast: X and y travel as tensors, and the small
    arrays as numpy (a ``BlockTopology`` W as it is)."""
    def host(a):
        return _host(a) if isinstance(a, torch.Tensor) else a
    return dataclasses.replace(req, X=None, y=None, W=host(req.W),
                               rho=host(req.rho), cv_rho=host(req.cv_rho))


class DecsvmFitServer(FifoEngine):
    """Batched, optionally asynchronous fit server.

    Synchronous use::

        srv = DecsvmFitServer()
        h = srv.submit(FitRequest(rid=0, ...))
        done = srv.run()        # drains the queue bucket by bucket

    Asynchronous use::

        srv.start()             # background worker resolves buckets
        h = srv.submit(...)     # returns immediately
        res = h.result()        # blocks until this request resolves
        srv.stop()

    Inside a group of k ranks, every rank makes the server; rank 0
    serves as above and ends with ``stop()``, and the others run::

        srv.follow()            # each chunked bucket, until rank 0 stops

    ``max_batch`` caps how many same-key requests co-batch into one
    bucket.  ``bucket_log`` records (key, size) per executed bucket (on a
    follower, per chunked bucket it ran).  ``device`` is where the
    buckets run (default CUDA, this rank's card; raises without one).
    """

    def __init__(self, max_batch: int = 16, device=None) -> None:
        super().__init__()
        self.max_batch = max_batch
        self.device = resolve_device(None, device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread sets it: a thread starts on card 0
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._rank = mesh_mod.rank()
        # rank 0 in a group: set once stop() released the followers, or
        # once the ranks diverged (the error, raised from then on)
        self._released = False
        self._diverged: Optional[RanksDiverged] = None
        self._step_lock = threading.Lock()
        # rolling (key, size) of recent buckets, bounded
        self.bucket_log: deque = deque(maxlen=256)
        # rid -> (request, handle, bucket key, resolved lambda grid)
        self._reqs: Dict[int, Tuple[FitRequest, FitHandle, tuple,
                                    np.ndarray]] = {}
        self._completed: Dict[int, FitResult] = {}
        # bucket failures awaiting a run() drain; bounded — every failure
        # is also delivered to its handles at completion time
        self._errors: deque = deque(maxlen=16)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight: set = set()          # rids popped into a running bucket
        self._last_bucket = 0
        self._buckets = 0                    # buckets popped: a bucket's id
        self._worker: Optional[threading.Thread] = None
        self._stop = False

    # -- public API ---------------------------------------------------------

    def submit(self, req: FitRequest) -> FitHandle:
        """Enqueue; returns a ``FitHandle`` future.  Raises ``ValueError``
        if ``req.rid`` is already pending, in flight, or
        completed-but-undelivered.  The request object is not mutated: a
        ``lams=None`` grid is resolved into the server's own record."""
        from repro_torch.core import sanitize
        if self._rank != 0:
            raise RuntimeError(
                f"submit() on rank {self._rank}: rank 0 is the front end of "
                f"the group and takes the requests; call follow() here")
        if self._diverged is not None:
            raise self._diverged
        if self._released:
            raise RuntimeError("the server has stopped: stop() released "
                               "the followers of the group")
        sanitize.reject_unsupported(req.cfg, "DecsvmFitServer.submit")
        lams = (tuning.lambda_grid(_host(req.X), _host(req.y), num=req.num)
                if req.lams is None else np.asarray(req.lams))
        key = self._bucket_key(req, lams)
        handle = FitHandle(req.rid, self)
        with self._cv:
            if (req.rid in self._reqs or req.rid in self._inflight
                    or req.rid in self._completed):
                raise ValueError(
                    f"duplicate fit request rid={req.rid}: still pending or "
                    f"undelivered (drain with run() / handle.result() first)")
            self._reqs[req.rid] = (req, handle, key, lams)
            self.queue.append(req.rid)
            if spans.enabled():
                handle._queued_ns = spans.clock()
            self._cv.notify_all()
        return handle

    def run(self) -> Dict[int, FitResult]:
        """Drain the queue and return the results completed since the last
        drain, removing them from the server.  If any bucket failed since
        the last drain, the first failure is re-raised here (after the
        queue drains; the affected handles carry the same exception, and
        buffered results stay for the next ``run()``).  After the ranks
        of a group diverged it raises ``RanksDiverged``."""
        while True:
            if self._diverged is not None:
                raise self._diverged
            if self._worker is None:
                while self.step():
                    pass
            with self._cv:
                if self.queue or self._inflight:
                    if self._worker is None and self.queue:
                        # a concurrent submit() landed after the step loop
                        # drained: resolve it inline
                        continue
                    # a worker (or another thread's inline step) owns the
                    # in-flight bucket: sleep until its completion notify
                    self._cv.wait()
                    continue
                if self._errors:
                    err = self._errors.popleft()
                    self._errors.clear()
                    raise err
                out, self._completed = self._completed, {}
                return out

    def step(self) -> int:
        """Resolve ONE bucket: pop up to ``max_batch`` queued requests
        sharing the queue head's bucket key and run them.  Returns the
        bucket size (0 if the queue was empty).  A bucket failure is
        recorded (re-raised by ``run()``) and delivered to the affected
        handles, not raised here — except ``RanksDiverged``, which is
        delivered to every handle still waiting and raised."""
        with self._step_lock:
            return self._step_locked()

    def _step_locked(self) -> int:
        with self._cv:
            batch = self._pop_bucket_locked()
        if not batch:
            return 0
        with spans.span("serve.bucket", bucket=self._buckets,
                        size=len(batch), engine=batch[0][2][-1]):
            self._resolve(batch)
        return len(batch)

    def _resolve(self, batch) -> None:
        """Run a popped bucket and deliver its results or its error."""
        try:
            results = self._run_bucket([req for req, _, _, _ in batch],
                                       batch[0][2], batch[0][3])
            error = None
        except RanksDiverged as e:
            with self._cv:
                self._diverged = e
                for req, handle, _, _ in batch:
                    handle._set(None, e)
                    self._inflight.discard(req.rid)
                for rid in self.queue:
                    self._reqs.pop(rid)[1]._set(None, e)
                self.queue.clear()
                self._cv.notify_all()
            raise
        except Exception as e:              # deliver failure to every handle
            results, error = None, e
        with spans.span("serve.deliver"), self._cv:
            for i, (req, handle, _, _) in enumerate(batch):
                if error is None:
                    self._completed[req.rid] = results[i]
                    handle._set(results[i])
                else:
                    handle._set(None, error)
                self._inflight.discard(req.rid)
            if error is not None:
                self._errors.append(error)
            self._cv.notify_all()

    def start(self) -> None:
        """Spawn the background worker (async mode)."""
        if self._worker is not None:
            return
        self._stop = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="decsvm-fit-worker",
                                        daemon=True)
        self._worker.start()

    def stop(self) -> None:
        """Stop the worker after the queue drains.  On rank 0 of a group,
        then release the followers: their ``follow()`` returns, and this
        server takes no more requests."""
        if self._worker is not None:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            self._worker.join()
            self._worker = None
        if (mesh_mod.device_count() > 1 and self._rank == 0
                and not self._released and self._diverged is None):
            mesh_mod.broadcast_from(0, None)
            self._released = True

    def follow(self) -> Dict[int, object]:
        """On a rank other than 0 of a group: run each chunked bucket that
        rank 0 broadcasts, as rank 0 runs it, until rank 0 stops.  Returns,
        by rid, each chunked request's ``FitResult`` — or the exception
        its bucket raised on every rank, after which it went on following.
        Raises ``RanksDiverged`` when the ranks disagree on a bucket's
        outcome."""
        if self._rank == 0:
            raise RuntimeError("follow() on rank 0: rank 0 is the front end "
                               "(submit / run / start / stop)")
        out: Dict[int, object] = {}
        while True:
            msg, tensors = mesh_mod.broadcast_from(0)
            if msg is None:
                return out
            key, lams, stubs = msg
            reqs = self._filled(stubs, tensors)
            self.bucket_log.append((key, len(reqs)))
            try:
                for res in self._lockstep(reqs, lams):
                    out[res.rid] = res
            except RanksDiverged:
                raise
            except Exception as e:          # the same on every rank
                for req in reqs:
                    out[req.rid] = e

    @property
    def utilization(self) -> float:
        """Batch-slot occupancy of the most recent bucket while work is
        queued or in flight; 0.0 once the server is idle."""
        with self._lock:
            if not self.queue and not self._inflight:
                return 0.0
            return self._last_bucket / self.max_batch

    # -- scheduling internals ------------------------------------------------

    @staticmethod
    def _w_shape(W) -> tuple:
        """Adjacency shape without densifying: a ``BlockTopology`` keys by
        its (m, m) logical shape."""
        if hasattr(W, "neighbors"):
            return (W.m, W.m)
        return _shape(W)

    @staticmethod
    def _resolve_engine(req: FitRequest) -> str:
        """"auto" -> "chunked" iff the network is larger than the rank
        count; explicit "dense"/"chunked" pass through."""
        if req.engine != "auto":
            if req.engine not in ("dense", "chunked"):
                raise ValueError(f"engine {req.engine!r} not in "
                                 f"('auto', 'dense', 'chunked')")
            return req.engine
        m = DecsvmFitServer._w_shape(req.W)[0]
        return "chunked" if m > mesh_mod.device_count() else "dense"

    @staticmethod
    def _bucket_key(req: FitRequest, lams: np.ndarray) -> tuple:
        return (_shape(req.X),
                DecsvmFitServer._w_shape(req.W), req.cfg,
                tuple(float(l) for l in np.asarray(lams).ravel()),
                req.mode, req.criterion, req.cv_folds, req.cv_seed,
                req.penalty, req.threshold, req.tol, req.stop_rule,
                req.check_every, DecsvmFitServer._resolve_engine(req))

    def _pop_bucket_locked(self) -> List[Tuple[FitRequest, FitHandle,
                                               tuple, np.ndarray]]:
        if not self.queue:
            return []
        key = self._reqs[self.queue[0]][2]      # computed once, at submit
        rids = [r for r in self.queue if self._reqs[r][2] == key]
        rids = rids[:self.max_batch]
        taken = set(rids)
        self.queue = type(self.queue)(r for r in self.queue
                                      if r not in taken)
        batch = [self._reqs.pop(r) for r in rids]
        self._inflight |= taken
        self._last_bucket = len(batch)
        self._buckets += 1
        self.bucket_log.append((key, len(batch)))
        if spans.enabled():
            now = spans.clock()
            for req, handle, _, _ in batch:
                if handle._queued_ns is not None:
                    spans.record("serve.queue", handle._queued_ns, now,
                                 rid=req.rid, bucket=self._buckets)
        return batch

    def _worker_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self.queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self.queue:
                    return
            try:
                self.step()     # bucket failures are recorded, not raised
            except RanksDiverged:
                return          # delivered to every handle; run() raises

    def _drive(self, handle: FitHandle, timeout: Optional[float]) -> None:
        """Resolve buckets inline until ``handle`` is done (sync mode);
        with a worker running, just let ``result()`` wait on the event.
        The deadline is honoured at bucket granularity: no *new* bucket
        starts past it."""
        if self._worker is not None:
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while not handle.done():
            if deadline is not None and time.monotonic() >= deadline:
                break                   # result() raises TimeoutError
            if self.step() == 0:
                break                   # rid not queued here; wait/timeout

    def _mark_delivered(self, rid: int) -> None:
        with self._cv:
            self._completed.pop(rid, None)

    # -- bucket execution ----------------------------------------------------

    def _rhos(self, reqs, Xs, cfg, cv_rho: bool):
        """The bucket's (B, m) rho — the requests' own, computed on the
        card where missing — and, for CV, its (B, k, m) ``cv_rho`` when
        every request carries one (else None: the engine computes them)."""
        rho = None
        if any(r.rho is not None for r in reqs):
            rho = torch.stack([
                as_f32(r.rho, self.device) if r.rho is not None else
                solver.compute_rho(Xs[b], cfg.h, cfg.kernel, cfg.rho_safety)
                for b, r in enumerate(reqs)])
        folds = None
        if cv_rho and all(r.cv_rho is not None for r in reqs):
            folds = torch.stack([as_f32(r.cv_rho, self.device)
                                 for r in reqs])
        return rho, folds

    def _result(self, req, best_lam, B, table, lam_weights, margins, y,
                wall, size) -> FitResult:
        return FitResult(
            rid=req.rid, best_lam=float(best_lam), B=B, beta=B.mean(axis=0),
            table=table, criterion=req.criterion, lam_weights=lam_weights,
            train_accuracy=metrics.margin_accuracy(margins, y),
            consensus_gap=metrics.consensus_gap(B), wall_s=wall,
            batch_size=size)

    def _run_bucket(self, reqs: List[FitRequest], key: tuple,
                    lams: np.ndarray) -> List[FitResult]:
        if key[-1] == "chunked":
            # every rank runs the bucket: the followers get it first
            tensors = [t for r in reqs for t in (as_f32(r.X, self.device),
                                                 as_f32(r.y, self.device))]
            stubs = [_stub(r) for r in reqs]
            mesh_mod.broadcast_from(0, (key, lams, stubs), tensors)
            return self._lockstep(self._filled(stubs, tensors), lams)
        return self._run_bucket_dense(reqs, lams)

    @staticmethod
    def _filled(stubs, tensors) -> List[FitRequest]:
        """The broadcast requests with their X and y tensors."""
        return [dataclasses.replace(s, X=tensors[2 * i], y=tensors[2 * i + 1])
                for i, s in enumerate(stubs)]

    def _lockstep(self, reqs: List[FitRequest],
                  lams: np.ndarray) -> List[FitResult]:
        """``_run_bucket_chunked`` on this rank, then the group's agreement
        on its outcome: its results, or the error every rank raised, or
        ``RanksDiverged``."""
        try:
            out, error = self._run_bucket_chunked(reqs, lams), None
        except Exception as e:
            out, error = None, e
        if not mesh_mod.same_on_every_rank(_outcome(error)):
            raise RanksDiverged(
                f"rank {self._rank}: the ranks disagree on the chunked bucket "
                f"of rids {[r.rid for r in reqs]} (here: "
                f"{'ran' if error is None else repr(error)})") from error
        if error is not None:
            raise error
        return out

    def _run_bucket_dense(self, reqs: List[FitRequest],
                          lams: np.ndarray) -> List[FitResult]:
        t0 = time.perf_counter()
        r0 = reqs[0]
        dev = self.device
        # the stack moves to the card once; every call below reads it there
        with spans.span("serve.stack"):
            Xs = torch.stack([as_f32(r.X, dev) for r in reqs])
            ys = torch.stack([as_f32(r.y, dev) for r in reqs])
            Ws = torch.stack([as_f32(r.W, dev) for r in reqs])
        rho, cv_rho = self._rhos(reqs, Xs, r0.cfg, r0.criterion == "cv")
        best_lams, _, tables, res = tuning.select_lambda_path_many(
            Xs, ys, Ws, r0.cfg, lams=lams, mode=r0.mode, tol=r0.tol,
            criterion=r0.criterion, cv_folds=r0.cv_folds,
            cv_seed=r0.cv_seed, stop_rule=r0.stop_rule,
            check_every=r0.check_every, rho=rho, cv_rho=cv_rho, device=dev)
        best_B = res.best_B                                 # (B, m, p)
        best_l = res.best_lam                               # (B,) fp32
        lam_weights = None
        if r0.penalty is not None:
            # One-step LLA stage 2, whole bucket at once: the path result
            # is the stage-1 pilot at each problem's best_lam, so only the
            # weighted re-fit runs, each problem at its own lambda
            from repro_torch.core import penalties  # keep serving light
            from repro_torch.core.path import decsvm_fit_many
            wfun = penalties.PENALTIES[r0.penalty]
            pilots = torch.mean(best_B, dim=1)              # (B, p)
            ws = torch.stack([wfun(pilot, lam) for pilot, lam in
                              zip(pilots, best_l)])         # (B, p)
            best_B = decsvm_fit_many(Xs, ys, Ws, best_l, r0.cfg,
                                     lam_weights=ws, rho=rho, device=dev)
            lam_weights = _host(ws)
        if r0.threshold:
            # Theorem-4 hard thresholding at each problem's selected lambda
            best_B = hard_threshold_final(best_B, best_l[:, None, None])
        with spans.span("serve.margins"):
            margins = _host(torch.bmm(Xs.flatten(0, 1),
                                      best_B.flatten(0, 1)[..., None])
                            .reshape(ys.shape))
            best_B, ys_h = _host(best_B), _host(ys)         # one transfer
        wall = time.perf_counter() - t0
        return [self._result(req, best_lams[i], best_B[i], tables[i],
                             None if lam_weights is None else lam_weights[i],
                             margins[i], ys_h[i], wall, len(reqs))
                for i, req in enumerate(reqs)]

    def _run_bucket_chunked(self, reqs: List[FitRequest],
                            lams: np.ndarray) -> List[FitResult]:
        """Chunked bucket: one problem already spans every rank through the
        node-chunk mesh, so the requests resolve one after another, each
        moved to the card once.  In a group every rank runs it on the same
        requests."""
        from repro_torch.core import decentral   # keep serving light

        t0 = time.perf_counter()
        r0 = reqs[0]
        dev = self.device
        out = []
        for req in reqs:
            X, y = as_f32(req.X, dev), as_f32(req.y, dev)
            rho = None if req.rho is None else as_f32(req.rho, dev)
            bl, _, table, res = tuning.select_lambda_path(
                X, y, req.W, r0.cfg, lams=lams, mode=r0.mode, tol=r0.tol,
                criterion=r0.criterion, cv_folds=r0.cv_folds,
                cv_seed=r0.cv_seed, stop_rule=r0.stop_rule,
                engine="chunked", rho=rho, cv_rho=req.cv_rho, device=dev)
            B, lam = res.best_B, res.best_lam
            lam_weights = None
            if r0.penalty is not None:
                # One-step LLA stage 2: one grid point through the chunked
                # path engine, with the per-coordinate weights
                from repro_torch.core import penalties  # keep serving light
                ws = penalties.PENALTIES[r0.penalty](torch.mean(B, dim=0),
                                                     lam)
                B = decentral.decsvm_path_chunked(
                    X, y, req.W, np.asarray([bl], np.float32), r0.cfg,
                    lam_weights=ws, rho=rho, device=dev)[0]
                lam_weights = _host(ws)
            if r0.threshold:
                B = hard_threshold_final(B, lam)
            margins = _host(torch.bmm(X, B[..., None])[..., 0])
            out.append((req, bl, _host(B), table, lam_weights, margins,
                        _host(y)))
        wall = time.perf_counter() - t0
        return [self._result(req, bl, B, table, lw, margins, y, wall,
                             len(reqs))
                for req, bl, B, table, lw, margins, y in out]
