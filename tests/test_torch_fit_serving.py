"""Torch port, fit serving (``repro_torch.serving.fit``), mirroring
``tests/test_fit_serving.py`` (not ``test_decsvm_head_tuned_fit``, which
waits on ROADMAP Queue 1 item 14) and ``tests/test_fit_serving_batched.py``.

Each port ``FitResult`` is held against JAX's ``DecsvmFitServer`` on the
same requests: the same engine tag in the bucket key (``engine="auto"``
sends every network of more than one node to the chunked engine on one
rank, on both sides), equal ``best_lam`` and ``train_accuracy``, ``B``
and the table within 1e-5 (fp32, sums in another order), the LLA weights
within 1e-5 and ``consensus_gap`` within 1e-6.  The port's requests carry
JAX's rho (and each CV fold's), as ``tests/test_torch_solver.py``
explains.  The scheduling semantics — drain once, duplicate rids, bucket
failures, async handles, timeouts, zero-margin ties — are the JAX tests'.
Everything runs on the CPU (``device="cpu"``).
"""
import dataclasses as dc
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ADMMConfig, SimConfig, generate, solver, tuning
from repro.core.graph import BlockTopology, erdos_renyi
from repro.serving import DecsvmFitServer as JServer
from repro.serving import FitRequest as JRequest
import repro_torch.core as tc
from repro_torch.core import metrics
from repro_torch.core import path as tpath
from repro_torch.core import penalties as tpen
from repro_torch.core import tuning as ttuning
from repro_torch.kernels import ops
from repro_torch.serving import DecsvmFitServer, FitRequest
from _torch_cases import one_thread  # noqa: F401

MAX_ITER = 80
NPROB = 3
FOLDS = 3
ATOL = 1e-5
GAP_ATOL = 1e-6


def _rhos(X, n_folds=FOLDS):
    rho = np.asarray(solver.compute_rho(jnp.asarray(X), 0.25,
                                        "epanechnikov", 1.05))
    masks = tuning.kfold_masks(X.shape[0], X.shape[1], n_folds, seed=0)
    cv_rho = np.stack([np.asarray(solver.compute_rho(
        jnp.asarray(X), 0.25, "epanechnikov", 1.05, mask=jnp.asarray(mk)))
        for mk in masks])
    return rho, cv_rho


def _problems(cfg, seeds, p_connect):
    out = []
    for s in seeds:
        X, y, _ = generate(cfg, seed=s)
        W = erdos_renyi(cfg.m, p_connect, seed=s)
        out.append((X, y, W) + _rhos(X))
    return out


@pytest.fixture(scope="module")
def sims():
    """Three same-shape problems (different data + adjacency) + shared grid,
    as in ``tests/test_fit_serving_batched.py``."""
    cfg = SimConfig(p=16, s=3, m=4, n=48, rho=0.5, mu=0.5)
    probs = _problems(cfg, range(NPROB), 0.7)
    lams = tuning.lambda_grid(probs[0][0], probs[0][1], num=4)
    return cfg, probs, lams


@pytest.fixture(scope="module")
def sim():
    """``tests/test_fit_serving.py``'s problem."""
    cfg = SimConfig(p=24, s=4, m=4, n=80, rho=0.5, mu=0.5)
    X, y, _ = generate(cfg, seed=5)
    W = erdos_renyi(cfg.m, 0.7, seed=5)
    return (cfg, X, y, W) + _rhos(X)


def _acfg(max_iter=MAX_ITER, backend="jnp"):
    return ADMMConfig(lam=0.0, max_iter=max_iter, backend=backend)


def _cfg(max_iter=MAX_ITER, backend="jnp"):
    return tc.ADMMConfig(lam=0.0, max_iter=max_iter, backend=backend)


def _requests(probs, lams, rids=None, backend="jnp", max_iter=MAX_ITER,
              **kw):
    """The same requests for JAX's server and the port's (with JAX's rho)."""
    rids = list(range(len(probs))) if rids is None else rids
    jreqs = [JRequest(rid=r, X=X, y=y, W=W, cfg=_acfg(max_iter), lams=lams,
                      **kw) for r, (X, y, W, _, _) in zip(rids, probs)]
    treqs = [FitRequest(rid=r, X=X, y=y, W=W, cfg=_cfg(max_iter, backend),
                        lams=lams, rho=rho, cv_rho=cv_rho, **kw)
             for r, (X, y, W, rho, cv_rho) in zip(rids, probs)]
    return jreqs, treqs


_CACHE = {}


def _jax_run(key, jreqs):
    """JAX's server on ``jreqs``: (results, bucket_log), once per key."""
    if key not in _CACHE:
        srv = JServer()
        for r in jreqs:
            srv.submit(r)
        _CACHE[key] = (srv.run(), list(srv.bucket_log))
    return _CACHE[key]


def _port_run(treqs, **srv_kw):
    srv = DecsvmFitServer(device="cpu", **srv_kw)
    for r in treqs:
        srv.submit(r)
    return srv.run(), srv


def _assert_same(got, want):
    """A port ``FitResult`` against JAX's at the stated tiers."""
    assert got.rid == want.rid and got.criterion == want.criterion
    assert got.best_lam == want.best_lam
    assert got.batch_size == want.batch_size
    assert isinstance(got.B, np.ndarray) and got.B.shape == want.B.shape
    np.testing.assert_allclose(got.B, want.B, atol=ATOL)
    np.testing.assert_allclose(got.beta, want.beta, atol=ATOL)
    np.testing.assert_allclose(np.array(got.table), np.array(want.table),
                               atol=ATOL)
    assert got.train_accuracy == want.train_accuracy
    assert abs(got.consensus_gap - want.consensus_gap) <= GAP_ATOL
    if want.lam_weights is None:
        assert got.lam_weights is None
    else:
        assert isinstance(got.lam_weights, np.ndarray)
        np.testing.assert_allclose(got.lam_weights, want.lam_weights,
                                   atol=ATOL)


def _tags(log):
    return [(key[-1], size) for key, size in log]


def _check_pair(key, probs, lams, backend="jnp", **kw):
    jreqs, treqs = _requests(probs, lams, backend=backend, **kw)
    want, jlog = _jax_run(key, jreqs)
    got, srv = _port_run(treqs)
    assert sorted(got) == sorted(want)
    assert _tags(srv.bucket_log) == _tags(jlog)
    for rid in want:
        _assert_same(got[rid], want[rid])
    return got, srv


# -- tests/test_fit_serving.py -----------------------------------------------


def test_fit_server_completes_tuned_requests(sim):
    cfg, X, y, W, rho, cv_rho = sim
    lams = tuning.lambda_grid(X, y, num=4)
    kw = [dict(mode="batched"), dict(mode="batched", criterion="cv",
                                     cv_folds=FOLDS)]
    jsrv, srv = JServer(), DecsvmFitServer(device="cpu")
    for rid, k in enumerate(kw):
        jsrv.submit(JRequest(rid=rid, X=X, y=y, W=W,
                             cfg=_acfg(max_iter=120), lams=lams, **k))
        srv.submit(FitRequest(rid=rid, X=X, y=y, W=W,
                              cfg=_cfg(max_iter=120), lams=lams, rho=rho,
                              cv_rho=cv_rho, **k))
    want, done = jsrv.run(), srv.run()
    assert sorted(done) == [0, 1]
    assert _tags(srv.bucket_log) == _tags(jsrv.bucket_log)
    for rid, res in done.items():
        _assert_same(res, want[rid])
        assert res.B.shape == (cfg.m, cfg.p + 1)
        assert res.beta.shape == (cfg.p + 1,)
        assert len(res.table) == len(lams)
        assert np.isfinite(res.B).all()
        assert res.train_accuracy > 0.7
        assert res.consensus_gap < 1e-2
    # the BIC request reproduces the library-surface selection
    best_lam, best_B, _, _ = ttuning.select_lambda_path(
        X, y, W, _cfg(max_iter=120), lams=lams, mode="batched", rho=rho,
        device="cpu")
    assert done[0].best_lam == pytest.approx(best_lam)
    np.testing.assert_allclose(done[0].B, best_B, atol=1e-6)


def test_fit_server_lla_and_threshold(sim):
    cfg, X, y, W, rho, cv_rho = sim
    lams = tuning.lambda_grid(X, y, num=4)
    kw = dict(mode="batched", penalty="scad", threshold=True)
    jsrv, srv = JServer(), DecsvmFitServer(device="cpu")
    jsrv.submit(JRequest(rid=7, X=X, y=y, W=W, cfg=_acfg(max_iter=120),
                         lams=lams, **kw))
    srv.submit(FitRequest(rid=7, X=X, y=y, W=W, cfg=_cfg(max_iter=120),
                          lams=lams, rho=rho, **kw))
    res = srv.run()[7]
    _assert_same(res, jsrv.run()[7])
    assert res.lam_weights is not None
    assert res.lam_weights.shape == (cfg.p + 1,)
    nz = res.B[np.abs(res.B) > 0]
    assert nz.size == 0 or np.min(np.abs(nz)) > res.best_lam


# -- tests/test_fit_serving_batched.py ---------------------------------------


def _stacked(probs):
    return [np.stack([p[i] for p in probs]) for i in range(5)]


@pytest.mark.serving_smoke
@pytest.mark.parametrize("criterion,mode", [("bic", "warm"),
                                            ("bic", "batched"),
                                            ("cv", "warm"),
                                            ("cv", "batched")])
def test_select_many_matches_serial(sims, criterion, mode):
    """The port's problem stack reproduces its per-request serial
    ``select_lambda_path`` and JAX's ``select_lambda_path_many`` to 1e-5."""
    _, probs, lams = sims
    Xs, ys, Ws, rho, cv_rho = _stacked(probs)
    kw = dict(lams=lams, mode=mode, criterion=criterion, cv_folds=FOLDS)
    bl, bB, tables, res = ttuning.select_lambda_path_many(
        Xs, ys, Ws.astype(np.float32), _cfg(), rho=rho, cv_rho=cv_rho,
        device="cpu", **kw)
    jbl, jbB, jtables, jres = tuning.select_lambda_path_many(
        Xs, ys, Ws.astype(np.float32), _acfg(), **kw)
    np.testing.assert_array_equal(bl, jbl)
    np.testing.assert_allclose(bB, jbB, atol=ATOL)
    np.testing.assert_allclose(np.array(tables), np.array(jtables), atol=ATOL)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    for b, (X, y, W, r, cr) in enumerate(probs):
        sl, sB, _, sres = ttuning.select_lambda_path(
            X, y, W, _cfg(), rho=r, cv_rho=cr, device="cpu", **kw)
        assert float(bl[b]) == pytest.approx(sl, abs=1e-7)
        np.testing.assert_allclose(bB[b], sB, atol=ATOL)
        np.testing.assert_allclose(res.criteria[b].numpy(),
                                   sres.criteria.numpy(), atol=ATOL)
        np.testing.assert_allclose(res.path[b].numpy(), sres.path.numpy(),
                                   atol=ATOL)


@pytest.mark.serving_smoke
@pytest.mark.parametrize("engine,backend", [("auto", "jnp"),
                                            ("auto", "megakernel"),
                                            ("dense", "jnp"),
                                            ("dense", "megakernel"),
                                            ("chunked", "pallas")])
def test_batched_server_lla_threshold_matches_jax(sims, engine, backend):
    """The bucketed LLA stage 2 + Theorem-4 thresholding against JAX's
    server (which runs ``jnp``), on either engine and the kernel backends,
    and against the port's serial per-request pipeline."""
    _, probs, lams = sims
    done, srv = _check_pair(("lla", engine), probs, lams, backend=backend,
                            mode="batched", penalty="scad", threshold=True,
                            engine=engine)
    tag = "dense" if engine == "dense" else "chunked"
    assert _tags(srv.bucket_log) == [(tag, NPROB)]
    for i, (X, y, W, rho, _) in enumerate(probs):
        sl, sB, _, _ = ttuning.select_lambda_path(
            X, y, W, _cfg(), lams=lams, mode="batched", rho=rho,
            device="cpu")
        w = tpen.PENALTIES["scad"](torch.tensor(sB).mean(0),
                                   torch.tensor(sl, dtype=torch.float32))
        B2 = tc.decsvm_fit(X, y, W, dc.replace(_cfg(), lam=sl),
                           lam_weights=w, rho=rho, device="cpu")
        B2 = tc.hard_threshold_final(B2, sl).numpy()
        res = done[i]
        assert res.best_lam == pytest.approx(sl, abs=1e-7)
        assert res.batch_size == NPROB
        np.testing.assert_allclose(res.lam_weights, w.numpy(), atol=ATOL)
        np.testing.assert_allclose(res.B, B2, atol=ATOL)
        nz = res.B[np.abs(res.B) > 0]
        assert nz.size == 0 or np.min(np.abs(nz)) > res.best_lam


@pytest.mark.serving_smoke
@pytest.mark.parametrize("mode,criterion", [("warm", "bic"),
                                            ("batched", "cv")])
def test_server_modes_match_jax(sims, mode, criterion):
    _, probs, lams = sims
    _check_pair(("modes", mode, criterion), probs, lams, mode=mode,
                criterion=criterion, cv_folds=FOLDS, tol=1e-3)


@pytest.mark.serving_smoke
def test_mixed_shape_queue_buckets_never_cross_shapes(sims):
    """An interleaved queue of two shapes resolves as shape-pure buckets,
    in JAX's order, and every request matches JAX's."""
    _, probs, lams = sims
    cfg_b = SimConfig(p=10, s=2, m=3, n=32, rho=0.5, mu=0.5)
    probs_b = _problems(cfg_b, (10, 11), 0.9)
    lams_b = tuning.lambda_grid(probs_b[0][0], probs_b[0][1], num=3)
    order = [(0, probs[0], lams), (100, probs_b[0], lams_b),
             (1, probs[1], lams), (101, probs_b[1], lams_b),
             (2, probs[2], lams)]
    jsrv, srv = JServer(), DecsvmFitServer(device="cpu")
    for rid, prob, grid in order:
        j, t = _requests([prob], grid, rids=[rid], mode="batched")
        jsrv.submit(j[0])
        srv.submit(t[0])
    want, done = jsrv.run(), srv.run()
    assert sorted(done) == [0, 1, 2, 100, 101]
    assert [size for _, size in srv.bucket_log] == [3, 2]
    assert _tags(srv.bucket_log) == _tags(jsrv.bucket_log)
    for key, _ in srv.bucket_log:
        assert key[0] in (probs[0][0].shape, probs_b[0][0].shape)
    for rid in want:
        _assert_same(done[rid], want[rid])


@pytest.mark.serving_smoke
def test_run_drains_and_duplicate_rid_raises(sims):
    """run() returns each result exactly once, and a duplicate rid raises
    until its result is delivered."""
    _, probs, lams = sims
    (_, t5), (_, t6), (_, t7) = (_requests(probs[:1], lams, rids=[r],
                                           mode="batched")
                                 for r in (5, 6, 7))
    srv = DecsvmFitServer(device="cpu")
    srv.submit(t5[0])
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit(t5[0])
    first = srv.run()
    assert sorted(first) == [5]
    assert srv.run() == {}                 # drained: delivered exactly once
    srv.submit(t6[0])
    h = srv.submit(t7[0])
    while srv.step():
        pass
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit(t6[0])
    assert h.result().rid == 7             # handle delivery drains rid 7
    srv.submit(t7[0])                      # delivered rid may be reused
    assert sorted(srv.run()) == [6, 7]


@pytest.mark.serving_smoke
def test_bucket_failure_surfaces_and_request_not_mutated(sims):
    _, probs, lams = sims
    X, y, W, rho, _ = probs[0]
    srv = DecsvmFitServer(device="cpu")
    bad = FitRequest(rid=0, X=X, y=y, W=W, cfg=_cfg(), lams=lams,
                     mode="batched", penalty="not-a-penalty", rho=rho)
    h = srv.submit(bad)
    with pytest.raises(KeyError):
        srv.run()
    with pytest.raises(KeyError):
        h.result()
    good = FitRequest(rid=1, X=X, y=y, W=W, cfg=_cfg(), num=3,
                      mode="batched", rho=rho)
    srv.submit(good)
    assert good.lams is None
    done = srv.run()
    assert sorted(done) == [1] and len(done[1].table) == 3
    # the grid resolved at submit is JAX's, traversed in fp32
    np.testing.assert_array_equal(
        np.array([r[0] for r in done[1].table], np.float32),
        tuning.lambda_grid(X, y, num=3).astype(np.float32))


@pytest.mark.serving_smoke
def test_async_worker_and_handles(sims):
    """start()/stop(): handles resolve off-thread, results match the
    synchronous server, utilization stays in [0, 1]."""
    _, probs, lams = sims
    _, treqs = _requests(probs, lams, mode="batched")
    want, _ = _port_run(treqs)
    srv = DecsvmFitServer(device="cpu")
    srv.start()
    handles = [srv.submit(r) for r in _requests(probs, lams,
                                                mode="batched")[1]]
    for i, h in enumerate(handles):
        res = h.result(timeout=300)
        assert h.done()
        np.testing.assert_allclose(res.B, want[i].B, atol=ATOL)
    assert 0.0 <= srv.utilization <= 1.0
    srv.stop()
    assert srv.pending == 0
    assert srv.utilization == 0.0


def test_concurrent_submitters_each_get_their_result_once(sims):
    """Stress: more submitting threads than cores against the worker, with
    a short switch interval; every request resolves exactly once, into
    buckets whose sizes add up to the requests, and nothing is left."""
    import sys
    import threading
    _, probs, lams = sims
    X, y, W, rho, _ = probs[0]
    cfg = _cfg(max_iter=3)
    srv = DecsvmFitServer(max_batch=8, device="cpu")
    results, errors = {}, []

    def client(base):
        try:
            hs = [srv.submit(FitRequest(rid=base + i, X=X, y=y, W=W, cfg=cfg,
                                        lams=lams[:2], mode="batched",
                                        engine="dense", rho=rho))
                  for i in range(2)]
            for h in hs:
                results[h.rid] = h.result(timeout=120)
        except Exception as e:                 # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv.start()
        threads = [threading.Thread(target=client, args=(100 * k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        srv.stop()
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert sorted(results) == sorted(100 * k + i for k in range(16)
                                     for i in range(2))
    assert sum(size for _, size in srv.bucket_log) == 32
    assert srv.run() == {} and srv.pending == 0
    for res in results.values():
        np.testing.assert_array_equal(res.B, results[0].B)


@pytest.mark.serving_smoke
def test_sync_result_honours_timeout(sims):
    _, probs, lams = sims
    srv = DecsvmFitServer(device="cpu")
    h = srv.submit(_requests(probs[:1], lams, mode="batched")[1][0])
    with pytest.raises(TimeoutError):
        h.result(timeout=0.0)
    assert sorted(srv.run()) == [0]
    assert h.result().rid == 0


@pytest.mark.serving_smoke
def test_zero_margin_ties_predict_positive(sims):
    """An all-zero fit (grid pinned above lambda_max) predicts +1
    everywhere: accuracy is the positive-class rate, as in JAX."""
    _, probs, lams = sims
    big = float(lams[0]) * 4.0
    done, _ = _check_pair("ties", probs[:1], [big], mode="batched",
                          threshold=True)
    res = done[0]
    X, y = probs[0][0], probs[0][1]
    assert np.all(res.B == 0.0)
    pos_rate = float(np.mean(y == 1.0))
    assert pos_rate > 0.0
    assert res.train_accuracy == pytest.approx(pos_rate)
    assert metrics.margin_accuracy(np.zeros_like(y), y) == pytest.approx(
        pos_rate)


def _counted(monkeypatch):
    """Stand-in counters: each wrapper call counts as one launch."""
    for name in ("csvm_round_block", "csvm_block_update",
                 "csvm_local_update"):
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            ops.launches[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    ops.reset_launches()


@pytest.mark.serving_smoke
def test_full_bucket_of_16_runs_as_one_bucket(sims, monkeypatch):
    """A full 16-request same-key bucket resolves as ONE bucket through
    the problem stack (dense, megakernel: one round-kernel launch a grid
    point and problem); a second equal bucket reproduces it bit for bit
    with the same launches."""
    _, probs, lams = sims
    _counted(monkeypatch)
    srv = DecsvmFitServer(max_batch=16, device="cpu")

    def bucket(base):
        for i in range(16):
            X, y, W, rho, _ = probs[i % NPROB]
            srv.submit(FitRequest(rid=base + i, X=X, y=y, W=W,
                                  cfg=_cfg(backend="megakernel"), lams=lams,
                                  mode="batched", engine="dense", rho=rho))
        ops.reset_launches()
        return srv.run(), ops.launches["csvm_round_block"]

    done, n1 = bucket(0)
    assert sorted(done) == list(range(16))
    assert [size for _, size in srv.bucket_log] == [16]
    assert all(done[i].batch_size == 16 for i in range(16))
    assert n1 == 16 * len(lams)
    done2, n2 = bucket(100)
    assert n2 == n1
    assert [size for _, size in srv.bucket_log] == [16, 16]
    for i in range(16):
        np.testing.assert_array_equal(done2[100 + i].B, done[i].B)


def test_fit_many_traced_lambda_matches_static(sims):
    """decsvm_fit_many with per-problem lambdas reproduces per-problem
    decsvm_fit at cfg.lam."""
    _, probs, lams = sims
    Xs, ys, Ws, rho, _ = _stacked(probs)
    per_lam = np.asarray([lams[1], lams[2], lams[3]], np.float32)
    got = tpath.decsvm_fit_many(Xs, ys, Ws, per_lam, _cfg(), rho=rho,
                                device="cpu").numpy()
    for b, (X, y, W, r, _) in enumerate(probs):
        want = tc.decsvm_fit(X, y, W, dc.replace(_cfg(),
                                                 lam=float(per_lam[b])),
                             rho=r, device="cpu")
        np.testing.assert_allclose(got[b], want.numpy(), atol=ATOL)


def test_select_many_builds_shared_grid(sims):
    """lams=None pools the per-problem lambda_max: JAX's shared grid."""
    _, probs, _ = sims
    Xs, ys, Ws, rho, _ = _stacked(probs)
    bl, bB, tables, res = ttuning.select_lambda_path_many(
        Xs, ys, Ws, _cfg(), num=4, mode="batched", rho=rho, device="cpu")
    lams = res.lams.numpy()
    assert lams.shape == (NPROB, 4)
    np.testing.assert_array_equal(lams[0], lams[1])
    np.testing.assert_array_equal(
        lams[0], tuning.shared_lambda_grid(Xs, ys, num=4).astype(np.float32))
    assert np.max(np.abs(res.path.numpy()[:, 0])) < 0.05


@pytest.mark.serving_smoke
def test_engine_tags_match_jax(sims):
    """``engine="auto"`` resolves as JAX's does on one rank: chunked for
    m > 1 (a dense adjacency or a ``BlockTopology``), dense for a
    one-node network; explicit engines pass through; others raise."""
    _, probs, lams = sims
    X, y, W = probs[0][:3]
    X1, y1, W1 = X[:1], y[:1], np.zeros((1, 1), np.float32)
    cases = [(X, y, W, "auto"), (X, y, BlockTopology.from_dense(W), "auto"),
             (X, y, W, "dense"), (X, y, W, "chunked"), (X1, y1, W1, "auto")]
    for Xc, yc, Wc, engine in cases:
        jkey = JServer._bucket_key(JRequest(rid=0, X=Xc, y=yc, W=Wc,
                                            lams=lams, engine=engine), lams)
        key = DecsvmFitServer._bucket_key(FitRequest(
            rid=0, X=Xc, y=yc, W=Wc, lams=lams, engine=engine), lams)
        assert key[-1] == jkey[-1]
        assert key[0] == jkey[0] and key[1] == jkey[1]
    for srv in (JServer(), DecsvmFitServer(device="cpu")):
        req = (JRequest if isinstance(srv, JServer) else FitRequest)(
            rid=0, X=X, y=y, W=W, lams=lams, engine="ring")
        with pytest.raises(ValueError, match="engine"):
            srv.submit(req)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecsvmFitServer()


def test_chip_smoke_fit_serving_phase_on_the_cpu(monkeypatch):
    """The chip run's fit-serving phase at a tiny size on the CPU (plain
    versions; stand-in counters), so that its control flow and its gates
    are rehearsed before the card."""
    import chip_smoke

    _counted(monkeypatch)
    sim = tc.SimConfig(p=30, s=5, m=5, n=24, rho=0.5)
    d = chip_smoke.Data(torch, tc, sim, device="cpu")
    design = chip_smoke.Data(torch, tc, tc.SimConfig(p=12, s=3, m=3, n=20,
                                                     rho=0.5), device="cpu")
    out = chip_smoke.fit_serving_phase(torch, tc, ops, d, design,
                                       max_iter=30, num=4, n_bucket=3,
                                       cv_folds=2)
    L = 4
    # the dense bucket, and the one launch of the unchecked full-size fit
    assert out["launches"]["csvm_round_block"] == 3 * L + 3 + 1
    assert out["dense_round_launches"] == 3 * L + 3
    assert out["chunked_launches"] == L * 30
    assert out["warm_launches"] == sum(
        chip_smoke.CHECK_EVERY * math.ceil(int(t) / chip_smoke.CHECK_EVERY)
        for t in out["warm_iters"])
    assert out["sanitize_launches"] == 30
    # the chunked path, the warm request twice (sync and async), the
    # sanitized fit
    assert out["launches"]["csvm_block_update"] == (
        L * 30 + 2 * out["warm_launches"] + 30)
    assert set(out["times"]) >= {"dense", "chunked", "warm", "cv", "async",
                                 "sanitize", "gossip"}


@pytest.fixture(scope="module")
def phase21():
    """chip_smoke.py's phase 21 on the CPU: four gloo ranks, the full-size
    problem shrunk to X (16, 64, 64), the design size as on the card (plain
    versions; the bucket records count the wrappers' calls).  Returns the
    phase's records and the inputs its gate was given (setup, the ranks'
    records, the one-rank run, the plain run)."""
    import chip_smoke
    from repro_torch.launch import ranks
    kept, gate = [], ranks.check_fit_serving

    def keep(*args, **kw):
        kept.append(args[:4])
        return gate(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ranks, "check_fit_serving", keep)
        rec = chip_smoke.fit_serving_ranks_phase(torch, device="cpu",
                                                 small=True)
    return rec, kept[0]


def test_chip_smoke_fit_serving_ranks_phase_on_the_cpu(phase21):
    """The chip run's phase 21 at a small size on the CPU: the group's
    buckets as the phase expects them, each result within 1e-5 of the
    one-rank server's and of plain, the broadcasts counted, and the calls
    a rank that the card's launches will count."""
    from repro_torch.launch import ranks
    rec, (s, got, _, _) = phase21
    assert rec["backend"] == "gloo" and len(rec["ranks"]) == 4
    assert [(b["engine"], b["rids"]) for b in rec["buckets"]] == \
        list(ranks.SERVE_BUCKETS)
    full, dense = rec["buckets"][0], rec["buckets"][1]
    # the full request on a (node_chunk 2, lam 2) mesh: 2 cells a rank
    assert [c["csvm_block_update"] for c in full["launches"]] == \
        [2 * ranks.MAX_ITER] * 4
    assert dense["launches"] == [{"csvm_round_block": len(s.design_grid)}]
    assert dense["comm_bytes"] == [{}]
    for b in rec["buckets"]:
        for f in b["fits"].values():
            assert max(f["max_abs_dev"], f["max_abs_dev_plain"]) <= ranks.TOL
    sent = [r["bytes"] for r in rec["ranks"]]
    xs = 4 * (16 * 64 * 64 + 16 * 64 + 2 * (10 * 200 * 101 + 10 * 200))
    assert sent == [xs] * 4
    assert got[0]["results"][2].best_lam > 0


def _bump(a, by=1e-3):
    a = a.copy()
    a.flat[0] += by
    return a


def _follower_result(s, got, one, plain):
    r = got[2]["results"][0]
    got[2]["results"][0] = dc.replace(r, B=_bump(r.B, 1e-7))


def _dense_collective(s, got, one, plain):
    got[0]["buckets"][1]["comm_calls"] = 1


def _follower_ran_dense(s, got, one, plain):
    got[1]["buckets"].insert(1, dict(got[0]["buckets"][1]))


def _one_rank_B(s, got, one, plain):
    r = one["results"][3]
    one["results"][3] = dc.replace(r, B=_bump(r.B))


def _plain_best_lam(s, got, one, plain):
    r = plain["results"][0]
    plain["results"][0] = dc.replace(r, best_lam=0.5 * r.best_lam)


def _one_rank_stops(s, got, one, plain):
    path, iters = one["paths"][2]
    one["paths"][2] = (path, iters - 4)


def _lost_launch(s, got, one, plain):
    got[3]["buckets"][0]["calls"]["csvm_block_update"] -= 1


def _bucket_order(s, got, one, plain):
    b = got[0]["buckets"]
    b[2], b[3] = b[3], b[2]


@pytest.mark.parametrize("change, match", [
    (_follower_result, "rank 2's result differs"),
    (_dense_collective, "dense bucket issued collectives"),
    (_follower_ran_dense, "rank 1 ran buckets"),
    (_one_rank_B, "max|dev|"),
    (_plain_best_lam, "best lambda"),
    (_one_rank_stops, "stops"),
    (_lost_launch, "expected 600 csvm_block_update"),
    (_bucket_order, "rank 0's buckets"),
])
def test_phase21_gate_fails_a_result_past_its_tolerance(phase21, change,
                                                        match):
    """Each of phase 21's gates fails on a record moved past it."""
    import copy
    from repro_torch.launch import ranks
    args = copy.deepcopy(phase21[1])
    change(*args)
    with pytest.raises(ranks.RankFailure, match=re.escape(match)):
        ranks.check_fit_serving(*args, log=lambda *a: None)
