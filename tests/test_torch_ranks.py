"""Torch port, the decentralized engines across ranks: gloo groups of 2
and 4 ranks on the CPU (``repro_torch.launch.ranks.spawn``), each running
every case of ``tests/_torch_ranks.py`` once, held to JAX's
single-device dense drivers computed here on the same numpy inputs, at
the tolerances of the JAX multi-device tests they mirror
(``tests/test_distributed.py``, ``tests/test_chunked.py``; those run
JAX's engines on 8 host devices, which this host's jax cannot).  The
ranks take JAX's rho (and each CV fold's).

Every rank must return the same global result, and each result must
match the port's own engine at one rank within 1e-6 — the block
schedule's 200-round runs within the fp32 tier 1e-5 (its neighbour sum
adds the diagonal and the rotated off-diagonal blocks in another order
than the one-rank dense block; measured 4.6e-6) — and the warm hand-off,
a different traversal across lam shards, is held to JAX's dense warm
path instead (``tests/test_torch_ranks_cases.py`` holds it to the port's
one-rank traversal of the same shards).  The two groups start together
in threads, and the references are computed here while they run; the
smaller group also runs the one-rank calls, spread over its ranks.
"""
import concurrent.futures
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as tr
from repro.core import ADMMConfig, decsvm_fit, solver, tuning
from repro.core.admm_adaptive import decsvm_fit_tol
from repro.core.path import (decsvm_path_batched, decsvm_path_select,
                             decsvm_path_warm)
from repro_torch.launch import ranks as tranks
from _torch_cases import one_thread  # noqa: F401

RANKS = [2, 4]
ROOT = Path(__file__).resolve().parents[1]


def _rho(X, mask=None):
    c = ADMMConfig()
    return np.asarray(solver.compute_rho(
        jnp.asarray(X), c.h, c.kernel, c.rho_safety,
        mask=None if mask is None else jnp.asarray(mask)))


@pytest.fixture(scope="module")
def d():
    return tr.inputs()


@pytest.fixture(scope="module")
def groups(d):
    """One spawn per group size, both started at once, and beside them the
    failure checks in a script of their own (one rank that hangs past a
    short deadline, then a rank that raises); the JAX references are
    computed while they run."""
    rho = {k: _rho(d[k]) for k in ("X", "Xh", "Xc", "Xu", "Xb")}
    for key, (m, n) in (("X", (8, 50)), ("Xb", (16, 12))):
        rho[f"{key} cv"] = np.stack([
            _rho(d[key], mk) for mk in tuning.kfold_masks(m, n, 3, seed=0)])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    script = subprocess.Popen(
        [sys.executable, "-c", FAILURES], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    pool = concurrent.futures.ThreadPoolExecutor(len(RANKS))
    # the one-rank runs do not depend on the group: the smaller group, the
    # quicker to finish its own cases, runs them
    futs = {k: pool.submit(tranks.spawn, tr.work, k, (rho, k == min(RANKS)),
                           device="cpu", deadline_s=240.0, timeout_s=120.0)
            for k in RANKS}
    futs["failures"] = script
    futs["refs"] = {key: fn(d, rho) for key, fn in REFS.items()}
    yield futs
    pool.shutdown(wait=True)
    script.kill()
    script.communicate()


# a script that calls ``spawn`` as ``chip_smoke.py`` does: a rank that
# never returns fails its call at the deadline (printed, seconds taken), a
# rank killed by SIGABRT fails its call (the message printed between two
# marker lines), then a rank that raises while its peer waits in a
# collective fails the script
FAILURES = """
import sys, time
import _torch_ranks as tr
from repro_torch.launch import ranks
t0 = time.monotonic()
try:
    ranks.spawn(tr.hang, 1, device="cpu", deadline_s=4.0)
except ranks.RankFailure as err:
    print(f"hang: {err} after {time.monotonic() - t0:.1f} s", flush=True)
try:
    ranks.spawn(tr.abort, 2, device="cpu", deadline_s=120.0)
except ranks.RankFailure as err:
    print(f"abort begins\\n{err}\\nabort ends", flush=True)
ranks.spawn(tr.fail, 2, device="cpu")
"""


def _run(groups, k):
    """(rank 0's results of the group of ``k``, the one-rank results);
    every rank's results equal rank 0's."""
    out = groups[k].result(timeout=300)
    got = out[0]["ranks"]
    assert [o["world"] for o in out] == [k] * k
    for o in out[1:]:
        for key in got:
            assert _dev(o["ranks"][key], got[key]) == 0.0, key
    one = {}
    for o in groups[min(RANKS)].result(timeout=300):
        one.update(o["one"])
    return got, one


def _dev(a, b) -> float:
    if isinstance(a, dict):
        return max(_dev(a[key], b[key]) for key in a)
    if isinstance(a, (tuple, list)):
        return max(_dev(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _one_rank(got, one, keys, tol=1e-6):
    for key in keys:
        assert _dev(got[key], one[key]) <= tol, (key, _dev(got[key],
                                                           one[key]))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# The references, each a function of the inputs and JAX's rho, computed
# once in the fixture while the groups run


def _want_fits(d, rho):
    X, y = _j(d["X"], d["y"])
    acfg = ADMMConfig(lam=0.05, max_iter=80)
    return {f"fit {s}{tag}": np.asarray(decsvm_fit(
        X, y, jnp.asarray(W), acfg,
        lam_weights=None if w is None else jnp.asarray(w)))
        for s, W in (("gather", d["W"]), ("ring", d["Wr"]))
        for tag, w in (("", None), (" lamw", d["w"]))}


def _want_paths(d, rho):
    X, y, lams = _j(d["X"], d["y"], d["lams"])
    acfg = ADMMConfig(lam=0.0, max_iter=80)
    return {f"path_sharded {s}": np.asarray(decsvm_path_batched(
        X, y, jnp.asarray(W), lams, acfg))
        for s, W in (("gather", d["W"]), ("ring", d["Wr"]))}


def _want_mesh(d, rho):
    X, y, W, lams = _j(d["X"], d["y"], d["W"], d["lams"])
    acfg = ADMMConfig(lam=0.0, max_iter=80)
    sel = decsvm_path_select(X, y, W, lams, acfg, mode="batched")
    return dict(dense=np.asarray(decsvm_path_batched(X, y, W, lams, acfg)),
                criteria=np.asarray(sel.criteria),
                best_lam=float(sel.best_lam),
                lamw=np.asarray(decsvm_path_batched(
                    X, y, W, lams, acfg, lam_weights=jnp.asarray(d["w2"]))))


def _want_warm(d, rho):
    X, y, W, lams = _j(d["Xh"], d["yh"], d["Wh"], d["lams_h"])
    return np.asarray(decsvm_path_warm(
        X, y, W.astype(jnp.float32), lams,
        ADMMConfig(lam=0.05, max_iter=800), tol=1e-5)[0])


def _want_chunked(d, rho):
    X, y, W, lams = _j(d["Xc"], d["yc"], d["Wc"], d["lams_c"])
    cfg = ADMMConfig(lam=0.1, max_iter=200)
    Bt, _ = decsvm_fit_tol(X, y, W, cfg, tol=1e-6)
    return dict(fit=np.asarray(decsvm_fit(
        X, y, W, ADMMConfig(lam=0.1, max_iter=40))), tol=np.asarray(Bt),
        path=np.asarray(decsvm_path_batched(X, y, W.astype(jnp.float32),
                                            lams, cfg)))


def _want_uneven(d, rho):
    X, y, W = _j(d["Xu"], d["yu"], d["Wu"])
    return np.asarray(decsvm_fit(X, y, W.astype(jnp.float32),
                                 ADMMConfig(lam=0.1, max_iter=40)))


def _want_block_mesh(d, rho):
    X, y, W, lams = _j(d["Xb"], d["yb"], d["Wb"], d["lams_c"])
    return np.asarray(decsvm_path_batched(
        X, y, W.astype(jnp.float32), lams, ADMMConfig(lam=0.1, max_iter=40)))


REFS = dict(fits=_want_fits, paths=_want_paths, mesh=_want_mesh,
            warm=_want_warm, chunked=_want_chunked, uneven=_want_uneven,
            block_mesh=_want_block_mesh)


@pytest.mark.parametrize("k", RANKS)
def test_sharded_fits_match_dense_gather_and_ring(groups, k):
    """tests/test_distributed.py:28-49 and :168-197: gather and ring fits,
    with and without lam_weights, within 1e-4 of the dense fit."""
    want = groups["refs"]["fits"]
    got, one = _run(groups, k)
    for key, B in want.items():
        assert np.max(np.abs(_np(got[key]) - B)) < 1e-4, key
    _one_rank(got, one, want)


@pytest.mark.parametrize("k", RANKS)
def test_sharded_path_matches_batched(groups, k):
    """tests/test_distributed.py:51-78: the sharded lambda path, gather
    and ring, within 1e-4 of the dense batched path."""
    want = groups["refs"]["paths"]
    got, one = _run(groups, k)
    for key, P in want.items():
        assert np.max(np.abs(_np(got[key]) - P)) < 1e-4, key
    _one_rank(got, one, want)


@pytest.mark.parametrize("k", RANKS)
def test_mesh_path_matches_batched(groups, k):
    """tests/test_distributed.py:80-130: the (node, lam) path within 1e-5
    of the dense batched path, its fused BIC within 1e-4 of the dense
    criterion with the same best lambda; the warm path stops within
    max_iter; CV scores are finite and leave the full-data path within
    1e-5; lam_weights within 1e-5."""
    want = groups["refs"]["mesh"]
    got, one = _run(groups, k)
    bic = got["mesh bic"]
    assert np.max(np.abs(_np(bic["path"]) - want["dense"])) < 1e-5
    assert np.max(np.abs(_np(bic["criteria"]) - want["criteria"])) < 1e-4
    assert abs(float(bic["best_lam"]) - want["best_lam"]) < 1e-8
    assert int(_np(got["mesh warm"]["iters"]).max()) <= 80
    cv = got["mesh cv"]
    assert np.all(np.isfinite(_np(cv["criteria"])))
    assert np.max(np.abs(_np(cv["path"]) - want["dense"])) < 1e-5
    assert np.max(np.abs(_np(got["mesh lamw"]["path"]) - want["lamw"])) < 1e-5
    _one_rank(got, one, ("mesh bic", "mesh warm", "mesh cv", "mesh lamw"))


@pytest.mark.parametrize("k", RANKS)
def test_tuning_and_lla_routes_run_on_the_group(groups, k):
    """``select_lambda_path(engine="mesh")`` and ``decsvm_fit_lla(engine=
    "sharded")`` called with no mesh inside the group run on the group's
    meshes and equal the dense routes at one rank (1e-6; the same best
    lambda)."""
    got, one = _run(groups, k)
    assert float(got["tuning"]["best_lam"]) == float(one["tuning"]["best_lam"])
    _one_rank(got, one, ("tuning", "lla"))


@pytest.mark.parametrize("k", RANKS)
def test_mesh_warm_handoff_matches_dense_warm_path(groups, k):
    """tests/test_distributed.py:132-166: with the hand-off the warm path
    on k lam shards lies within 5e-5 of the dense warm path, closer than
    without it, and no cell runs past max_iter."""
    want = groups["refs"]["warm"]
    got, _ = _run(groups, k)
    devs = {on: float(np.max(np.abs(_np(got[f"handoff {on}"]["path"])
                                    - want))) for on in (True, False)}
    for on in (True, False):
        assert int(_np(got[f"handoff {on}"]["iters"]).max()) <= 800
    assert devs[True] < 5e-5, devs
    assert devs[True] < devs[False], devs


@pytest.mark.parametrize("k", RANKS)
def test_chunked_fit_tol_and_path_match_dense(groups, k):
    """tests/test_chunked.py:107-150: m = 16 over k node chunks, each
    backend's fit, the ``tol=`` fit and the path within 1e-5 of the dense
    drivers (the JAX test pairs each backend with its dense fit; here
    each is held to the dense fit under jnp, the same fp32 math)."""
    want = groups["refs"]["chunked"]
    got, one = _run(groups, k)
    for backend in ("jnp", "pallas", "megakernel"):
        assert np.abs(_np(got[f"chunked {backend}"]) - want["fit"]).max() \
            <= 1e-5, backend
    B, rounds = got["chunked tol"]
    assert np.abs(_np(B) - want["tol"]).max() <= 1e-5
    assert int(rounds) <= 200
    assert np.abs(_np(got["chunked path"]) - want["path"]).max() <= 1e-5
    _one_rank(got, one, [f"chunked {b}" for b in ("jnp", "pallas",
                                                  "megakernel")])
    _one_rank(got, one, ("chunked tol", "chunked path"), tol=1e-5)


@pytest.mark.parametrize("k", RANKS)
def test_uneven_final_chunk_ghost_rows_are_exact_noops(groups, k):
    """tests/test_chunked.py:152-185: m = 13 over k chunks matches the
    dense fit within 1e-5, and the raw padded state's ghost rows stay
    exactly 0."""
    want = groups["refs"]["uneven"]
    got, one = _run(groups, k)
    assert np.abs(_np(got["uneven"]) - want).max() <= 1e-5
    raw = _np(got["uneven raw"])
    m_pad = math.ceil(13 / k) * k
    assert raw.shape[0] == m_pad and m_pad > 13
    assert np.all(raw[13:] == 0.0)
    assert np.abs(raw[:13] - want).max() <= 1e-5
    _one_rank(got, one, ("uneven",))


@pytest.mark.parametrize("k", RANKS)
def test_block_schedule_mesh_matches_gather_mesh(groups, k):
    """tests/test_chunked.py:187-220: the (node_chunk, lam) mesh under the
    block schedule against the (node, lam) mesh under gather, BIC and CV:
    the path and the criteria within 1e-5, the same best lambda; the
    gather mesh's path within 1e-5 of the dense batched path."""
    want = groups["refs"]["block_mesh"]
    got, one = _run(groups, k)
    for crit in ("bic", "cv"):
        g, b = got[f"block_mesh gather {crit}"], got[f"block_mesh block {crit}"]
        assert _dev(g["path"], b["path"]) <= 1e-5
        assert _dev(g["criteria"], b["criteria"]) <= 1e-5
        assert float(g["best_lam"]) == float(b["best_lam"])
        assert np.abs(_np(g["path"]) - want).max() <= 1e-5
    _one_rank(got, one, [key for key in got if key.startswith("block_mesh")])


@pytest.mark.parametrize("k", RANKS)
def test_consensus_mix_across_ranks(d, groups, k):
    """One Metropolis-style mixing round of per-node blocks gathered over
    the ranks equals the dense mixing product."""
    got, one = _run(groups, k)
    want = np.einsum("ij,jab->iab", d["Wmix"], d["grads"])
    np.testing.assert_allclose(_np(got["consensus"]), want, atol=1e-6)
    _one_rank(got, one, ("consensus",))


def _failures(groups):
    """The failure script's exit code, stdout and stderr, read once for
    the tests that share it."""
    if "failures read" not in groups:
        script = groups["failures"]
        out, err = script.communicate(timeout=180)
        groups["failures read"] = (script.returncode, out, err)
    return groups["failures read"]


def test_a_failing_or_hanging_rank_fails_the_call(groups):
    """A rank that never returns fails ``spawn`` at its deadline, and is
    killed; a rank that raises makes a script that calls ``spawn`` (as
    ``chip_smoke.py`` does) exit non-zero with ``RankFailure`` naming the
    rank, though its peer still waits in a collective."""
    returncode, out, err = _failures(groups)
    assert returncode != 0
    hang = [line for line in out.splitlines() if line.startswith("hang: ")]
    assert len(hang) == 1 and "deadline" in hang[0], out
    assert 4.0 <= float(hang[0].rsplit(" after ", 1)[1].split()[0]) < 60.0
    assert "RankFailure: rank " in err
    assert "rank 1: ValueError: rank 1 raises on purpose" in err


def test_a_rank_killed_by_a_signal_leaves_its_stack_in_the_failure(groups):
    """A rank that dies by SIGABRT (as a C++ abort in gloo kills it) fails
    ``spawn`` with a ``RankFailure`` that names the rank and ends with the
    tail of its stderr: faulthandler's report of the signal and the Python
    stack of the call that aborted, the dead rank's tail first."""
    _, out, _ = _failures(groups)
    text = out.split("abort begins\n", 1)[1].split("\nabort ends", 1)[0]
    assert text.startswith("rank 1 failed")
    assert "SIGABRT" in text.splitlines()[0]
    tail = text.split("--- stderr of rank 1, last ", 1)[1]
    assert "Fatal Python error: Aborted" in tail
    assert 'in abort' in tail and "_torch_ranks.py" in tail
