"""Torch port, fit serving across the ranks of a group: one gloo group of
4 ranks on the CPU (``repro_torch.launch.ranks.spawn``), every rank with a
``DecsvmFitServer`` (``tests/_torch_ranks.py:fit_serving``) — rank 0 the
front end, the others following — mirroring JAX's auto-routing test
(``tests/test_chunked.py:246-278``, which needs 8 host devices: m = 16
routes to the chunked engine, m = 4 to the dense one, at 4 ranks).

Every result is held to JAX's ``DecsvmFitServer`` with ``engine="dense"``
and to JAX's ``tuning.select_lambda_path`` on the same numpy inputs (the
port's requests carry JAX's rho), at 1e-5 with the same best lambda and
table lambdas; the followers' copies of each chunked result equal rank
0's bit for bit; a dense bucket runs on rank 0 alone and issues no
collective.  Beside the group, a script checks that a rank that never
follows, or that fails a bucket alone, fails the call with
``RankFailure``.  The JAX references are computed while the ranks run.
"""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as tr
from repro.core import ADMMConfig, solver, tuning
from repro.core.graph import ring as jring
from repro.serving import DecsvmFitServer as JServer
from repro.serving import FitRequest as JRequest
from repro_torch.core import graph
from repro_torch.launch import ranks as tranks
from test_torch_fit_serving import _assert_same
from _torch_cases import one_thread  # noqa: F401

RANKS = 4
ROOT = Path(__file__).resolve().parents[1]
WARM_TOL = 1e-3
# rank 0's buckets in order: run() drains rid 1 (m = 16: chunked) and rid 2
# (m = 4: dense); rid 5 raises on every rank, rid 6 is served after it;
# the worker takes rid 3 (warm) and rid 4 (LLA)
BUCKETS = [("chunked", [1]), ("dense", [2]), ("chunked", [6]),
           ("chunked", [3]), ("chunked", [4])]


def _rho(X):
    c = ADMMConfig()
    return np.asarray(solver.compute_rho(jnp.asarray(X), c.h, c.kernel,
                                         c.rho_safety))


def inputs():
    """JAX's test's draw (seed 9): X (16, 8, 5), labels from a sparse
    hyperplane, a ring of 16 as a ``BlockTopology`` (m = 16) and its
    first 4 nodes on a ring of 4 (m = 4), with JAX's rho."""
    rng = np.random.default_rng(9)
    m, n, p = 16, 8, 5
    X = rng.normal(size=(m, n, p)).astype(np.float32)
    b = np.zeros(p, np.float32)
    b[:2] = 1.0
    y = np.sign(X @ b + 0.1 * rng.normal(size=(m, n))).astype(np.float32)
    return dict(
        ring=(X, y, graph.BlockTopology.from_dense(graph.ring(m)), _rho(X)),
        head=(X[:4], y[:4], graph.ring(4), _rho(X[:4])),
        lams=np.geomspace(0.5, 0.05, 3), lams_warm=np.geomspace(0.5, 0.05, 5),
        warm_tol=WARM_TOL)


def _references(d):
    """JAX's dense server on every request of rank 0 that resolves, and
    JAX's ``select_lambda_path`` on the ones without a penalty: by rid."""
    X, y = d["ring"][:2]
    cfg = ADMMConfig(lam=0.0, max_iter=30)
    warm_cfg = ADMMConfig(lam=0.0, max_iter=60)
    cases = {
        1: (X, y, jring(16), cfg, dict(lams=d["lams"], mode="batched")),
        2: (X[:4], y[:4], jring(4), cfg, dict(lams=d["lams"],
                                                mode="batched")),
        3: (X, y, jring(16), warm_cfg, dict(lams=d["lams_warm"], mode="warm",
                                            tol=WARM_TOL)),
        4: (X, y, jring(16), cfg, dict(lams=d["lams"], mode="batched",
                                       penalty="scad", threshold=True))}
    srv = JServer()
    for rid, (Xr, yr, W, c, kw) in cases.items():
        srv.submit(JRequest(rid=rid, X=Xr, y=yr, W=W, cfg=c, engine="dense",
                            **kw))
    served = srv.run()
    paths = {rid: tuning.select_lambda_path(Xr, yr, W, c, **kw)
             for rid, (Xr, yr, W, c, kw) in cases.items()
             if "penalty" not in kw}
    return served, paths


# a script that calls ``spawn`` as ``chip_smoke.py`` does: rank 1 never
# follows, so the call fails at its deadline (printed, seconds taken); then
# rank 1 alone fails a bucket after its last exchange, so every rank raises
# RanksDiverged and the script fails with RankFailure
FAILURES = """
import sys, time
import _torch_ranks as tr
import test_torch_fit_serving_ranks as t
from repro_torch.launch import ranks
d = t.inputs()
t0 = time.monotonic()
try:
    ranks.spawn(tr.fit_serving_hang, 2, (d,), device="cpu", deadline_s=8.0)
except ranks.RankFailure as err:
    print(f"hang: {err} after {time.monotonic() - t0:.1f} s", flush=True)
ranks.spawn(tr.fit_serving_alone, 2, (d,), device="cpu", deadline_s=120.0)
"""


@pytest.fixture(scope="module")
def group():
    """The group of 4 and the failure script, started at once; the JAX
    references while they run."""
    d = inputs()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    script = subprocess.Popen(
        [sys.executable, "-c", FAILURES], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(tranks.spawn, tr.fit_serving, RANKS, (d,),
                      device="cpu", deadline_s=240.0, timeout_s=120.0)
    refs = _references(d)
    out = fut.result(timeout=300)
    yield dict(ranks=out, refs=refs, script=script)
    pool.shutdown(wait=True)
    script.kill()
    script.communicate()


def _tags(keys):
    return [key[-1] for key in keys]


def test_auto_routing_sends_large_m_to_chunked_and_small_to_dense(group):
    """tests/test_chunked.py:246-278 at 4 ranks: m = 16 > 4 ranks goes to
    the chunked engine, m = 4 to the dense one, never in one bucket; the
    buckets run in submit order."""
    r0 = group["ranks"][0]
    assert _tags(r0["keys"])[:2] == ["chunked", "dense"]
    assert [(b["engine"], b["rids"]) for b in r0["buckets"]] == BUCKETS
    res = r0["results"][1]
    assert np.all(np.isfinite(res.B)) and res.B.shape == (16, 5)
    assert r0["results"][2].B.shape == (4, 5)


@pytest.mark.parametrize("rid", [1, 2, 3, 4, 6])
def test_every_result_matches_jax(group, rid):
    """Each result against JAX's dense server (1e-5, the same best lambda
    and table lambdas) and, without a penalty, against JAX's
    ``select_lambda_path``; rid 6 is rid 1 served again after a failed
    bucket."""
    served, paths = group["refs"]
    want = dataclasses.replace(served[1 if rid == 6 else rid], rid=rid)
    got = group["ranks"][0]["results"][rid]
    _assert_same(got, want)
    if rid != 4:
        best_lam, best_B, table, _ = paths[1 if rid == 6 else rid]
        assert got.best_lam == float(best_lam)
        np.testing.assert_allclose(got.B, np.asarray(best_B), atol=1e-5)
        np.testing.assert_allclose(np.array(got.table), np.array(table),
                                   atol=1e-5)


def test_followers_hold_rank_0s_results_bit_for_bit(group):
    """Every follower ran each chunked bucket (the same keys as rank 0's)
    and holds each chunked result bit for bit; the failed bucket is
    recorded on every follower as the error rank 0 delivered."""
    r0, followers = group["ranks"][0], group["ranks"][1:]
    chunked = [key for key in r0["keys"] if key[-1] == "chunked"]
    for f in followers:
        assert f["keys"] == chunked
        assert sorted(f["results"]) == [1, 3, 4, 5, 6]
        assert isinstance(f["results"][5], KeyError)
        for rid in (1, 3, 4, 6):
            assert tranks._identical(f["results"][rid], r0["results"][rid])


def test_async_worker_stops_every_rank(group):
    """start() / submit / result() / stop(): the warm (KKT) and the LLA +
    threshold requests resolve through rank 0's worker, stop() returns
    every follower (the call returned), and rank 0 is idle after it."""
    r0 = group["ranks"][0]
    assert [o["rank"] for o in group["ranks"]] == list(range(RANKS))
    assert r0["pending"] == 0 and r0["utilization"] == 0.0
    assert r0["results"][4].lam_weights is not None
    nz = r0["results"][4].B[np.abs(r0["results"][4].B) > 0]
    assert nz.size == 0 or np.min(np.abs(nz)) > r0["results"][4].best_lam


def test_a_failing_bucket_reaches_rank_0_and_serving_goes_on(group):
    """A bucket that raises on every rank (an unknown penalty, after its
    path) is re-raised by run() and by its handle on rank 0; the next
    request resolves.  submit() on a follower raises."""
    r0 = group["ranks"][0]
    assert "not-a-penalty" in r0["errors"]["run"]
    assert r0["errors"]["handle"] == r0["errors"]["run"]
    assert 6 in r0["results"]
    for f in group["ranks"][1:]:
        assert "rank 0 is the front end" in f["errors"]["submit"]


def test_dense_bucket_runs_on_rank_0_alone(group):
    """The dense bucket issues no collective (``mesh.comm_bytes``) and no
    follower runs it."""
    r0 = group["ranks"][0]
    dense = [b for b in r0["buckets"] if b["engine"] == "dense"]
    assert len(dense) == 1 and dense[0]["rids"] == [2]
    assert dense[0]["comm_calls"] == 0 and dense[0]["comm_bytes"] == {}
    assert dense[0]["calls"].get("csvm_round_block", 0) == 0   # jnp
    for b in r0["buckets"]:
        if b["engine"] == "chunked":
            assert b["comm_calls"] > 0
    for f in group["ranks"][1:]:
        assert 2 not in f["results"]
        assert all(b["engine"] == "chunked" for b in f["buckets"])


def test_a_rank_that_fails_or_hangs_alone_fails_the_call(group):
    """A rank that never follows fails ``spawn`` at its deadline; a rank
    that alone fails a bucket after its last exchange makes every rank
    raise ``RanksDiverged`` — rank 0 hands out no result — and the script
    exit non-zero with ``RankFailure``."""
    script = group["script"]
    out, err = script.communicate(timeout=180)
    assert script.returncode != 0
    hang = [line for line in out.splitlines() if line.startswith("hang: ")]
    assert len(hang) == 1 and "deadline" in hang[0], out
    assert 8.0 <= float(hang[0].rsplit(" after ", 1)[1].split()[0]) < 60.0
    assert "rank 0 refused: rank 0: the ranks disagree" in out
    assert "RankFailure: rank " in err and "RanksDiverged" in err
