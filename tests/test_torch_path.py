"""Torch port, lambda path: on ``tests/test_path.py``'s fixture the port's
``repro_torch.core.path`` (batched, warm, CV, select, and the problem
stacks) under the ``jnp``, ``pallas`` and ``megakernel`` backends must
reproduce the JAX package's dense path: fp32 within 1e-5 with equal
``iters`` and ``best_lam``; ``megakernel_bf16`` within 1e-2 with
sign-exact support.  The fits take JAX's rho (and each CV fold's), as
``tests/test_torch_solver.py`` explains.  Everything runs on the CPU
(``device="cpu"``), where the kernels' wrappers take their plain versions;
stand-in counters show how many kernel launches each path makes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ADMMConfig, SimConfig, generate, solver, tuning
from repro.core import path as jpath
from repro.core.graph import erdos_renyi
import repro_torch.core as tc
from repro_torch.core import path as tpath
from repro_torch.core import tuning as ttuning
from repro_torch.kernels import ops
from _torch_cases import one_thread  # noqa: F401

MAX_ITER = 150
# fp32 tier: the same fp32 arithmetic in another summation order (XLA vs
# torch on the CPU), carried through 150 ADMM rounds a grid point.
ATOL = 1e-5
# bf16 tier: X and the dot operands in bf16, accumulators in fp32
# (measured ~5e-3 on this fixture).
ATOL_BF16 = 1e-2
FOLDS = 3
BACKENDS = ["jnp", "pallas", "megakernel"]
# (tol, check_every, stop_rule) of the warm path: the JAX tests' two KKT
# settings and the progress rule
WARM = [(1e-3, 4, "kkt"), (1e-4, 1, "kkt"), (1e-4, 4, "progress")]


def _problem(seed):
    cfg = SimConfig(p=24, s=4, m=4, n=80, rho=0.5, mu=0.5)
    X, y, _ = generate(cfg, seed=seed)
    W = np.asarray(erdos_renyi(cfg.m, 0.7, seed=1), np.float32)
    rho = np.asarray(solver.compute_rho(jnp.asarray(X), 0.25,
                                        "epanechnikov", 1.05))
    masks = tuning.kfold_masks(cfg.m, cfg.n, FOLDS, seed=0)
    cv_rho = np.stack([np.asarray(solver.compute_rho(
        jnp.asarray(X), 0.25, "epanechnikov", 1.05, mask=jnp.asarray(mk)))
        for mk in masks])
    return dict(X=X, y=y, W=W, rho=rho, cv_rho=cv_rho, masks=masks)


@pytest.fixture(scope="module")
def sim():
    d = _problem(3)
    d["lams"] = tuning.lambda_grid(d["X"], d["y"], num=5)
    return d


@pytest.fixture(scope="module")
def stack(sim):
    """Two same-shape problems (seeds 3 and 4) for the ``_many`` paths."""
    other = _problem(4)
    return {k: np.stack([sim[k], other[k]]) for k in other}


class _Jax:
    """JAX's results on the fixture, each computed once."""

    def __init__(self, sim, stack):
        self.sim, self.stack, self.cache = sim, stack, {}

    def __call__(self, key, fn):
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]

    def args(self):
        s = self.sim
        return (jnp.asarray(s["X"]), jnp.asarray(s["y"]), jnp.asarray(s["W"]),
                jnp.asarray(s["lams"]))


@pytest.fixture(scope="module")
def jax_paths(sim, stack):
    return _Jax(sim, stack)


ACFG = ADMMConfig(lam=0.0, max_iter=MAX_ITER)
# JAX's own bf16 path: where bf16 X moves a KKT stop, it moves JAX's too
ACFG_BF16 = ADMMConfig(lam=0.0, max_iter=MAX_ITER, backend="megakernel_bf16")


def _cfg(backend):
    return tc.ADMMConfig(lam=0.0, max_iter=MAX_ITER, backend=backend)


def _np(t):
    return t.detach().cpu().numpy()


def _jax_select(jax_paths, mode, criterion, acfg=ACFG):
    return jax_paths(("select", mode, criterion, acfg.backend),
                   lambda: jpath.decsvm_path_select(
                       *jax_paths.args(), acfg, mode=mode, tol=1e-3,
                       criterion=criterion, cv_folds=FOLDS))


def _assert_bf16_tier(got, want):
    """Within 1e-2 of the fp32 path, with the signs of every coefficient
    above 1e-2 in the fp32 path."""
    assert np.max(np.abs(got - want)) <= ATOL_BF16
    supp = np.abs(want) > ATOL_BF16
    np.testing.assert_array_equal(np.sign(got)[supp], np.sign(want)[supp])


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_path_matches_jax(sim, jax_paths, backend):
    want = jax_paths("batched", lambda: np.asarray(jpath.decsvm_path_batched(
        *jax_paths.args(), ACFG)))
    got = tpath.decsvm_path_batched(sim["X"], sim["y"], sim["W"], sim["lams"],
                                    _cfg(backend), rho=sim["rho"],
                                    device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


@pytest.mark.parametrize("warm", WARM)
@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_path_matches_jax(sim, jax_paths, backend, warm):
    tol, every, rule = warm
    want = jax_paths(("warm",) + warm, lambda: tuple(map(
        np.asarray, jpath.decsvm_path_warm(*jax_paths.args(), ACFG, tol=tol,
                                           stop_rule=rule,
                                           check_every=every))))
    path, iters = tpath.decsvm_path_warm(
        sim["X"], sim["y"], sim["W"], sim["lams"], _cfg(backend), tol=tol,
        stop_rule=rule, check_every=every, rho=sim["rho"], device="cpu")
    assert iters.dtype == torch.int32
    np.testing.assert_array_equal(_np(iters), want[1])
    np.testing.assert_allclose(_np(path), want[0], atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cv_scores_match_jax(sim, jax_paths, backend):
    want = jax_paths("cv", lambda: np.asarray(jpath.decsvm_path_cv(
        *jax_paths.args(), ACFG, jnp.asarray(sim["masks"]))))
    got = tpath.decsvm_path_cv(sim["X"], sim["y"], sim["W"], sim["lams"],
                               _cfg(backend), sim["masks"],
                               rho=sim["cv_rho"], device="cpu")
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


@pytest.mark.parametrize("criterion", ["bic", "cv"])
@pytest.mark.parametrize("mode", ["batched", "warm"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_path_select_matches_jax(sim, jax_paths, backend, mode, criterion):
    want = _jax_select(jax_paths, mode, criterion)
    got = tpath.decsvm_path_select(
        sim["X"], sim["y"], sim["W"], sim["lams"], _cfg(backend), mode=mode,
        tol=1e-3, criterion=criterion, cv_folds=FOLDS, rho=sim["rho"],
        cv_rho=sim["cv_rho"], device="cpu")
    assert isinstance(got, tpath.PathResult)
    np.testing.assert_array_equal(_np(got.lams), np.asarray(want.lams))
    assert float(got.best_lam) == float(want.best_lam)
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    np.testing.assert_allclose(_np(got.path), np.asarray(want.path),
                               atol=ATOL)
    np.testing.assert_allclose(_np(got.best_B), np.asarray(want.best_B),
                               atol=ATOL)
    np.testing.assert_allclose(_np(got.criteria), np.asarray(want.criteria),
                               atol=ATOL)


@pytest.mark.parametrize("case", ["batched", "warm", "select-bic",
                                  "select-cv"])
def test_megakernel_bf16_path_tolerance_tier(sim, jax_paths, case):
    """bf16 X through the path: within 1e-2 of JAX's fp32 path with
    sign-exact support; the KKT stops on the rounds of JAX's own bf16
    path."""
    cfg = _cfg("megakernel_bf16")
    args = (sim["X"], sim["y"], sim["W"], sim["lams"], cfg)
    kw = dict(rho=sim["rho"], device="cpu")
    if case == "batched":
        want = jax_paths("batched", lambda: np.asarray(
            jpath.decsvm_path_batched(*jax_paths.args(), ACFG)))
        _assert_bf16_tier(_np(tpath.decsvm_path_batched(*args, **kw)), want)
        return
    if case == "warm":
        want = jax_paths(("warm",) + WARM[0], lambda: tuple(map(
            np.asarray, jpath.decsvm_path_warm(*jax_paths.args(), ACFG,
                                               tol=1e-3))))
        want16 = jax_paths(("warm bf16",), lambda: np.asarray(
            jpath.decsvm_path_warm(*jax_paths.args(), ACFG_BF16, tol=1e-3)[1]))
        path, iters = tpath.decsvm_path_warm(*args, tol=1e-3, **kw)
        np.testing.assert_array_equal(_np(iters), want16)
        _assert_bf16_tier(_np(path), want[0])
        return
    criterion = case.split("-")[1]
    want = _jax_select(jax_paths, "warm", criterion)
    got = tpath.decsvm_path_select(*args, tol=1e-3, criterion=criterion,
                                   cv_folds=FOLDS, cv_rho=sim["cv_rho"], **kw)
    want16 = _jax_select(jax_paths, "warm", criterion, ACFG_BF16)
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want16.iters))
    assert float(got.best_lam) == float(want16.best_lam)
    _assert_bf16_tier(_np(got.path), np.asarray(want.path))


@pytest.mark.parametrize("backend", BACKENDS + ["megakernel_bf16"])
def test_fit_many_matches_jax(stack, jax_paths, backend):
    """Each problem at its own lambda and lam_weights, with its own rho."""
    lams = np.array([0.03, 0.05], np.float32)
    w = np.random.default_rng(0).uniform(0.3, 1.0, (2, 25)).astype(
        np.float32)
    want = jax_paths("many", lambda: np.asarray(jpath.decsvm_fit_many(
        jnp.asarray(stack["X"]), jnp.asarray(stack["y"]),
        jnp.asarray(stack["W"]), jnp.asarray(lams), ACFG,
        lam_weights=jnp.asarray(w))))
    got = tpath.decsvm_fit_many(stack["X"], stack["y"], stack["W"], lams,
                                _cfg(backend), lam_weights=w,
                                rho=stack["rho"], device="cpu")
    assert tuple(got.shape) == want.shape
    if backend == "megakernel_bf16":
        _assert_bf16_tier(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, atol=ATOL)


@pytest.mark.parametrize("mode,criterion", [("batched", "bic"),
                                            ("warm", "bic"), ("warm", "cv")])
@pytest.mark.parametrize("backend", BACKENDS + ["megakernel_bf16"])
def test_path_select_many_matches_jax(sim, stack, jax_paths, backend, mode,
                                      criterion):
    lams = tuning.shared_lambda_grid(stack["X"], stack["y"], num=5)
    want = jax_paths(("select_many", mode, criterion), lambda: (
        jpath.decsvm_path_select_many(
            jnp.asarray(stack["X"]), jnp.asarray(stack["y"]),
            jnp.asarray(stack["W"]), jnp.asarray(lams), ACFG, mode=mode,
            tol=1e-3, criterion=criterion, cv_folds=FOLDS)))
    got = tpath.decsvm_path_select_many(
        stack["X"], stack["y"], stack["W"], lams, _cfg(backend), mode=mode,
        tol=1e-3, criterion=criterion, cv_folds=FOLDS, rho=stack["rho"],
        cv_rho=stack["cv_rho"], device="cpu")
    for field in ("best_lam", "best_B", "lams", "path", "criteria",
                  "iters"):
        assert tuple(getattr(got, field).shape) == \
            tuple(np.asarray(getattr(want, field)).shape), field
    np.testing.assert_array_equal(_np(got.lams), np.asarray(want.lams))
    if backend == "megakernel_bf16":
        want16 = jax_paths(("select_many bf16", mode, criterion), lambda: (
            jpath.decsvm_path_select_many(
                jnp.asarray(stack["X"]), jnp.asarray(stack["y"]),
                jnp.asarray(stack["W"]), jnp.asarray(lams), ACFG_BF16,
                mode=mode, tol=1e-3, criterion=criterion, cv_folds=FOLDS)))
        np.testing.assert_array_equal(_np(got.iters),
                                      np.asarray(want16.iters))
        _assert_bf16_tier(_np(got.path), np.asarray(want.path))
        return
    np.testing.assert_array_equal(_np(got.best_lam),
                                  np.asarray(want.best_lam))
    np.testing.assert_array_equal(_np(got.iters), np.asarray(want.iters))
    np.testing.assert_allclose(_np(got.path), np.asarray(want.path),
                               atol=ATOL)
    np.testing.assert_allclose(_np(got.criteria), np.asarray(want.criteria),
                               atol=ATOL)


@pytest.mark.parametrize("many", [False, True])
def test_select_lambda_path_wrappers_match_jax(sim, stack, many):
    """The tuning wrappers build JAX's grid bit for bit when ``lams`` is
    omitted, and return its (best_lam, best_B, table) convention."""
    kw = dict(num=5, mode="warm", tol=1e-3)
    if many:
        jx = [jnp.asarray(stack[k]) for k in ("X", "y", "W")]
        want = tuning.select_lambda_path_many(*jx, ACFG, **kw)
        got = ttuning.select_lambda_path_many(
            stack["X"], stack["y"], stack["W"], _cfg("megakernel"),
            rho=stack["rho"], device="cpu", **kw)
        np.testing.assert_array_equal(got[0], want[0])
    else:
        jx = [jnp.asarray(sim[k]) for k in ("X", "y", "W")]
        want = tuning.select_lambda_path(*jx, ACFG, **kw)
        got = ttuning.select_lambda_path(sim["X"], sim["y"], sim["W"],
                                         _cfg("megakernel"), rho=sim["rho"],
                                         device="cpu", **kw)
        assert got[0] == want[0]
    assert isinstance(got[1], np.ndarray)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL)
    np.testing.assert_array_equal(_np(got[3].lams), np.asarray(want[3].lams))
    rows = lambda t: np.array(t, np.float64).reshape(-1, 3)
    np.testing.assert_allclose(rows(got[2]), rows(want[2]), atol=ATOL)


def _counted(monkeypatch, names=("csvm_round_block", "csvm_block_update",
                                 "csvm_local_update")):
    """Stand-in counters: each wrapper call counts as one launch (on the
    CPU the wrappers run their plain versions and count nothing)."""
    for name in names:
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            ops.launches[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    ops.reset_launches()


def test_path_launch_structure_on_the_megakernel_backend(sim, monkeypatch):
    """Batched: one round-kernel call per grid point; warm: one fused
    4-round + KKT call per check block, sum ceil(iters / 4); CV: none (the
    masked fits take the reference rounds); fit_many: one per problem."""
    _counted(monkeypatch)
    args = (sim["X"], sim["y"], sim["W"], sim["lams"], _cfg("megakernel"))
    kw = dict(rho=sim["rho"], device="cpu")
    tpath.decsvm_path_batched(*args, **kw)
    assert ops.launches["csvm_round_block"] == len(sim["lams"])
    ops.reset_launches()
    _, iters = tpath.decsvm_path_warm(*args, tol=1e-3, **kw)
    assert ops.launches["csvm_round_block"] == sum(
        math.ceil(int(t) / 4) for t in iters)
    ops.reset_launches()
    tpath.decsvm_path_cv(*args, sim["masks"], rho=sim["cv_rho"],
                         device="cpu")
    assert sum(ops.launches.values()) == 0
    tpath.decsvm_fit_many(np.stack([sim["X"]] * 3), np.stack([sim["y"]] * 3),
                          np.stack([sim["W"]] * 3), [0.01, 0.02, 0.03],
                          _cfg("megakernel"), device="cpu")
    assert ops.launches["csvm_round_block"] == 3


def test_unported_options_and_bad_arguments_raise(sim):
    args = (sim["X"], sim["y"], sim["W"], sim["lams"])
    kw = dict(rho=sim["rho"], device="cpu")
    bad = tc.ADMMConfig(lam=0.0, max_iter=3, sanitize=True)
    for fn in (tpath.decsvm_path_batched, tpath.decsvm_path_warm,
               tpath.decsvm_path_select):
        with pytest.raises(NotImplementedError, match="sanitize"):
            fn(*args, bad, **kw)
    with pytest.raises(NotImplementedError, match="sanitize"):
        tpath.decsvm_path_cv(*args, bad, sim["masks"], device="cpu")
    from repro_torch.launch.mesh import Mesh
    for engine, axis in (("mesh", "node"), ("chunked", "node_chunk")):
        with pytest.raises(ValueError, match="ranks"):
            ttuning.select_lambda_path(sim["X"], sim["y"], sim["W"],
                                       _cfg("jnp"), lams=sim["lams"],
                                       engine=engine,
                                       mesh=Mesh(((axis, 2), ("lam", 1))),
                                       **kw)
    with pytest.raises(ValueError, match="engine"):
        ttuning.select_lambda_path(sim["X"], sim["y"], sim["W"], _cfg("jnp"),
                                   lams=sim["lams"], engine="ring", **kw)
    for opt in (dict(mode="cold"), dict(stop_rule="gap"),
                dict(criterion="aic")):
        with pytest.raises(ValueError):
            tpath.decsvm_path_select(*args, _cfg("jnp"), **opt, **kw)
    with pytest.raises(ValueError, match="stop_rule"):
        tpath.decsvm_path_warm(*args, _cfg("jnp"), stop_rule="gap", **kw)
    with pytest.raises(ValueError, match="Xs"):
        tpath.decsvm_path_select_many(sim["X"], sim["y"], sim["W"],
                                      sim["lams"], _cfg("jnp"), **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpath.decsvm_path_batched(*args, _cfg("jnp"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttuning.select_lambda_path(sim["X"], sim["y"], sim["W"],
                                       _cfg("jnp"), lams=sim["lams"],
                                       device="cuda")


def test_chip_smoke_lambda_path_phase_on_the_cpu(monkeypatch):
    """The chip run's lambda-path phase at a tiny size on the CPU (plain
    versions; stand-in counters), so that its control flow and its launch
    checks are rehearsed before the card."""
    import chip_smoke

    _counted(monkeypatch)
    d = chip_smoke.Data(torch, tc, tc.SimConfig(p=30, s=5, m=5, n=24,
                                                rho=0.5), device="cpu")
    design = chip_smoke.Data(torch, tc, tc.SimConfig(p=12, s=3, m=3, n=20,
                                                     rho=0.5), device="cpu")
    out = chip_smoke.lambda_path_phase(torch, tc, ops, d, design,
                                       max_iter=30, num=4)
    runs = {k: v["launches"] for k, v in out["times"].items()
            if "launches" in v}
    assert runs["batched megakernel"] == 4
    assert runs["warm megakernel"] == sum(
        math.ceil(int(t) / 4) for t in out["warm_iters"])
    assert runs["warm megakernel_bf16"] == sum(
        math.ceil(int(t) / 4) for t in out["warm_bf16_iters"])
    assert runs["lla megakernel"] == out["lla_launches"] == 4 + 1
    assert out["launches"]["csvm_round_block"] == sum(runs.values())
    assert out["quickstart"]["Tuned"]["f1"] >= 0.9
