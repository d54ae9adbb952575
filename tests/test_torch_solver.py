"""Torch port, solver and drivers: on ``tests/test_solver.py``'s fixture the
port's ``decsvm_fit`` under every backend, with ``track_history``, and
``decsvm_fit_tol`` under both stop rules must reproduce the JAX package's
dense ``decsvm_fit`` (fp32 within 1e-5; bf16 within 1e-2 with sign-exact
support).  rho is the one input a seed cannot match (JAX draws its power
iteration start with ``jax.random``), so the fits take JAX's rho; the
port's own ``compute_rho`` is tested at a stated relative tolerance.
Everything runs on the CPU (``device="cpu"``), where the kernels' wrappers
take their plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (ADMMConfig, SimConfig, decsvm_fit, generate,
                        hard_threshold_final, objective, solver)
from repro.core.admm import ADMMState, admm_step
from repro.core.admm_adaptive import decsvm_fit_tol, decsvm_fit_uneven
from repro.core.graph import ring
import repro_torch.core as tc
from repro_torch.core import admm as tadmm
from repro_torch.core import admm_adaptive as tad
from repro_torch.core import solver as ts
from repro_torch.kernels import ops

MAX_ITER = 60
LAM = 0.05
# fp32 tier: the same fp32 arithmetic in another summation order (XLA vs
# torch on the CPU), carried through up to a few hundred ADMM rounds.
ATOL = 1e-5
# bf16 tier: X and the dot operands in bf16, accumulators in fp32
# (measured ~8e-4 on this fixture at 60 rounds).
ATOL_BF16 = 1e-2
# compute_rho: 50 power iterations from two different random starts agree
# to the iteration's convergence (measured 2.7e-4 on this fixture).
RHO_RTOL = 1e-3


@pytest.fixture(scope="module")
def fixture():
    cfg = SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = generate(cfg, seed=1)
    W = ring(cfg.m)
    rho = np.asarray(solver.compute_rho(jnp.asarray(X), 0.25,
                                        "epanechnikov", 1.05))
    return cfg, X, y, W, rho


@pytest.fixture(scope="module")
def dense(fixture):
    """JAX's dense fit: final B and the (T, m, p) history."""
    _, X, y, W, _ = fixture
    B, H = decsvm_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                      ADMMConfig(lam=LAM, max_iter=MAX_ITER),
                      track_history=True)
    return np.asarray(B), np.asarray(H)


def _cfg(**kw):
    return tc.ADMMConfig(lam=LAM, max_iter=MAX_ITER, **kw)


def _drivers(fixture):
    _, X, y, W, rho = fixture
    kw = dict(rho=rho, device="cpu")
    return {
        "jnp": lambda: tc.decsvm_fit(X, y, W, _cfg(), **kw),
        "pallas": lambda: tc.decsvm_fit(X, y, W, _cfg(use_pallas=True), **kw),
        "pallas-backend": lambda: tc.decsvm_fit(X, y, W,
                                                _cfg(backend="pallas"), **kw),
        "megakernel": lambda: tc.decsvm_fit(X, y, W,
                                            _cfg(backend="megakernel"), **kw),
        "megakernel-history": lambda: tc.decsvm_fit(
            X, y, W, _cfg(backend="megakernel"), track_history=True, **kw)[0],
        # tol = -1 runs the tolerance drivers through all MAX_ITER rounds
        "tol-progress": lambda: tc.decsvm_fit_tol(X, y, W, _cfg(), tol=-1.0,
                                                  **kw)[0],
        "tol-kkt": lambda: tc.decsvm_fit_tol(X, y, W, _cfg(), tol=-1.0,
                                             stop_rule="kkt", **kw)[0],
        "tol-kkt-every-1": lambda: tc.decsvm_fit_tol(
            X, y, W, _cfg(), tol=-1.0, stop_rule="kkt", check_every=1,
            **kw)[0],
        "megakernel-tol-progress": lambda: tc.decsvm_fit_tol(
            X, y, W, _cfg(backend="megakernel"), tol=-1.0, **kw)[0],
        "megakernel-tol-kkt": lambda: tc.decsvm_fit_tol(
            X, y, W, _cfg(backend="megakernel"), tol=-1.0, stop_rule="kkt",
            check_every=7, **kw)[0],
        "uneven-full-mask": lambda: tc.decsvm_fit_uneven(
            X, y, np.ones(y.shape, np.float32), W, _cfg(), **kw),
    }


@pytest.mark.parametrize("name", ["jnp", "pallas", "pallas-backend",
                                  "megakernel", "megakernel-history",
                                  "tol-progress", "tol-kkt",
                                  "tol-kkt-every-1",
                                  "megakernel-tol-progress",
                                  "megakernel-tol-kkt", "uneven-full-mask"])
def test_every_port_driver_matches_jax_dense(fixture, dense, name):
    got = _drivers(fixture)[name]()
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), dense[0], atol=ATOL)


def test_track_history_matches_jax_history(fixture, dense):
    _, X, y, W, rho = fixture
    for backend in ("jnp", "megakernel"):
        B, H = tc.decsvm_fit(X, y, W, _cfg(backend=backend),
                             track_history=True, rho=rho, device="cpu")
        assert tuple(H.shape) == dense[1].shape
        np.testing.assert_allclose(H.numpy(), dense[1], atol=ATOL)
        assert torch.equal(H[-1], B)


def test_megakernel_bf16_tolerance_tier(fixture, dense):
    """X in bf16 for the dots, B/P/statistic fp32: within 1e-2 of the fp32
    JAX fit, with sign-exact support at the JAX test's threshold."""
    _, X, y, W, rho = fixture
    for fit in (
        lambda c: tc.decsvm_fit(X, y, W, c, rho=rho, device="cpu"),
        lambda c: tc.decsvm_fit_tol(X, y, W, c, tol=-1.0, stop_rule="kkt",
                                    rho=rho, device="cpu")[0],
    ):
        B16 = fit(_cfg(backend="megakernel_bf16")).numpy()
        assert B16.dtype == np.float32
        assert np.max(np.abs(B16 - dense[0])) <= ATOL_BF16
        thr = 1e-2
        supp = np.abs(dense[0]) > thr
        np.testing.assert_array_equal(np.abs(B16) > thr, supp)
        np.testing.assert_array_equal(np.sign(B16)[supp],
                                      np.sign(dense[0])[supp])


def test_megakernel_bf16_matches_jax_bf16(fixture):
    _, X, y, W, rho = fixture
    want = np.asarray(decsvm_fit(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
        ADMMConfig(lam=LAM, max_iter=MAX_ITER, backend="megakernel_bf16")))
    got = tc.decsvm_fit(X, y, W, _cfg(backend="megakernel_bf16"), rho=rho,
                        device="cpu").numpy()
    assert np.max(np.abs(got - want)) <= ATOL_BF16


@pytest.mark.parametrize("stop_rule", ["progress", "kkt"])
@pytest.mark.parametrize("backend", ["jnp", "megakernel"])
def test_early_stop_lands_on_the_same_round(fixture, stop_rule, backend):
    """decsvm_fit_tol stops on the same measured round t as JAX's (a
    multiple of check_every) with the same iterate."""
    _, X, y, W, rho = fixture
    Bj, tj = decsvm_fit_tol(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                            ADMMConfig(lam=LAM, max_iter=2000), tol=1e-4,
                            stop_rule=stop_rule)
    Bt, tt = tc.decsvm_fit_tol(X, y, W,
                               tc.ADMMConfig(lam=LAM, max_iter=2000,
                                             backend=backend),
                               tol=1e-4, stop_rule=stop_rule, rho=rho,
                               device="cpu")
    assert int(tt) == int(tj) and int(tj) % 4 == 0 and int(tj) < 2000
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), atol=ATOL)


def test_max_iter_not_a_multiple_of_check_every(fixture, dense):
    """The fused run_tol holds the rounds past max_iter inside its last
    block (nact = min(k, max_iter - t) on the device)."""
    _, X, y, W, rho = fixture
    B, t = tc.decsvm_fit_tol(X, y, W, _cfg(backend="megakernel"), tol=-1.0,
                             stop_rule="kkt", check_every=7, rho=rho,
                             device="cpu")
    assert int(t) == MAX_ITER and MAX_ITER % 7 != 0
    B2, t2 = tc.decsvm_fit_tol(X, y, W, _cfg(), tol=-1.0, check_every=7,
                               rho=rho, device="cpu")
    assert int(t2) == MAX_ITER
    np.testing.assert_allclose(B.numpy(), dense[0], atol=ATOL)
    np.testing.assert_allclose(B2.numpy(), dense[0], atol=ATOL)


def test_round_block_fallback_when_the_rule_refuses(fixture, dense,
                                                    monkeypatch):
    """When the residency rule refuses, round_block loops single rounds
    whose primal goes through the ``csvm_block_update`` wrapper (never the
    reference ``local_update``), and the fit is unchanged."""
    _, X, y, W, rho = fixture
    monkeypatch.setattr(ops, "megakernel_supported", lambda *a, **k: False)

    def no_reference(*a, **k):
        raise AssertionError("the megakernel backend reached local_update")
    monkeypatch.setattr(ts, "local_update", no_reference)
    calls = {"csvm_block_update": 0, "csvm_round_block": 0}
    for name in calls:
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    B = tc.decsvm_fit(X, y, W, _cfg(backend="megakernel"), rho=rho,
                      device="cpu")
    np.testing.assert_allclose(B.numpy(), dense[0], atol=ATOL)
    assert calls == {"csvm_block_update": MAX_ITER, "csvm_round_block": 0}
    Bt, t = tc.decsvm_fit_tol(X, y, W, _cfg(backend="megakernel"), tol=-1.0,
                              stop_rule="kkt", check_every=7, rho=rho,
                              device="cpu")
    assert int(t) == MAX_ITER
    np.testing.assert_allclose(Bt.numpy(), dense[0], atol=ATOL)
    # rounds past max_iter inside the last 7-round block run and are held
    assert calls == {"csvm_block_update": MAX_ITER + 7 * (-(-MAX_ITER // 7)),
                     "csvm_round_block": 0}


def test_compute_rho_within_stated_rtol(fixture):
    _, X, _, _, rho_j = fixture
    rho_t = ts.compute_rho(torch.tensor(X), 0.25, "epanechnikov", 1.05)
    np.testing.assert_allclose(rho_t.numpy(), rho_j, rtol=RHO_RTOL)
    mask = np.ones(X.shape[:2], np.float32)
    mask[:, ::3] = 0.0
    want = np.asarray(solver.compute_rho(jnp.asarray(X), 0.25, "gaussian",
                                         1.05, mask=jnp.asarray(mask)))
    got = ts.compute_rho(torch.tensor(X), 0.25, "gaussian", 1.05,
                         mask=torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RHO_RTOL)
    # and the fit from the port's own rho stays close to JAX's
    B = tc.decsvm_fit(X, *fixture[2:4], _cfg(), device="cpu").numpy()
    Bj = tc.decsvm_fit(X, *fixture[2:4], _cfg(), rho=rho_j,
                       device="cpu").numpy()
    assert np.max(np.abs(B - Bj)) < 1e-3


def test_power_iteration_deterministic_and_robust():
    """The test_solver.py case: a zero-sum leading eigenvector is found
    from the seeded random start, the result repeats, and an all-zero
    block gives 0 instead of NaN."""
    rng = np.random.default_rng(7)
    p = 16
    q, _ = np.linalg.qr(rng.normal(size=(p, p)))
    v1 = q[:, 0] - np.mean(q[:, 0])
    v1 /= np.linalg.norm(v1)
    G = 5.0 * np.outer(v1, v1) + 1.0 * (np.eye(p) - np.outer(v1, v1))
    L = np.linalg.cholesky(G + 1e-9 * np.eye(p))
    X = torch.tensor(np.sqrt(p) * L.T, dtype=torch.float32)
    lmax = float(ts.power_iteration_lmax(X, iters=200))
    assert abs(lmax - 5.0) < 1e-2, lmax
    assert lmax == float(ts.power_iteration_lmax(X, iters=200))
    assert float(ts.power_iteration_lmax(torch.zeros(8, 5), iters=50)) == 0.0


def test_kkt_residual_parity(fixture, dense):
    _, X, y, W, rho = fixture
    acfg = ADMMConfig(lam=LAM, lam0=0.05)
    deg = W.sum(1)
    omega = 1.0 / (2.0 * deg + rho + acfg.lam0)
    jprob = solver.Problem(jnp.asarray(X), jnp.asarray(y), jnp.asarray(deg),
                           jnp.asarray(rho), jnp.asarray(omega), None)
    tprob, _ = ts.from_numpy(X, y, deg, rho, omega, dense[0], dense[0], 0,
                             device="cpu")
    w = np.random.default_rng(0).uniform(0.3, 1.0, X.shape[-1]).astype(
        np.float32)
    for B in (dense[0], dense[1][3]):
        for lw in (None, w):
            want = float(solver.kkt_residual(
                jprob, acfg, jnp.asarray(B), LAM,
                None if lw is None else jnp.asarray(lw)))
            got = float(ts.kkt_residual(
                tprob, acfg, torch.tensor(B), LAM,
                None if lw is None else torch.tensor(lw)))
            assert got == pytest.approx(want, abs=1e-6)
    with pytest.raises(NotImplementedError):
        ts.kkt_residual(tprob, acfg, torch.tensor(dense[0]), LAM,
                        node_mask=torch.ones(4))


def test_from_numpy_carries_state_across(fixture, dense):
    """A JAX Problem/SolverState, as numpy, continues in the port exactly
    as in JAX: ten more rounds from the 30th iterate of the JAX fit."""
    _, X, y, W, rho = fixture
    acfg = ADMMConfig(lam=LAM, max_iter=MAX_ITER)
    jprob = solver.make_problem(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(W), acfg, rho=jnp.asarray(rho))
    jstep = solver.make_step(acfg, lambda B: jnp.asarray(W) @ B)
    js = solver.run_fixed(jstep, jprob, LAM, num_iters=30)
    want = solver.run_fixed(jstep, jprob, LAM, num_iters=10, state=js)
    tprob, tstate = ts.from_numpy(*(np.asarray(a) for a in jprob[:5]),
                                  np.asarray(js.B), np.asarray(js.P),
                                  int(js.t), device="cpu")
    assert int(tstate.t) == 30 and tprob.X.dtype == torch.float32
    tW = torch.tensor(W)
    tstep = ts.make_step(tc.ADMMConfig(lam=LAM), lambda B: tW @ B)
    got = ts.run_fixed(tstep, tprob, LAM, num_iters=10, state=tstate)
    assert int(got.t) == int(want.t) == 40
    np.testing.assert_allclose(got.B.numpy(), np.asarray(want.B), atol=ATOL)
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), atol=ATOL)


def test_uneven_masked_fit_matches_jax(fixture):
    """Sample masks take the plain reference backend under every backend
    (the kernels have no mask operand) and match JAX's masked fit."""
    _, X, y, W, _ = fixture
    rng = np.random.default_rng(3)
    mask = (rng.random(y.shape) < 0.7).astype(np.float32)
    acfg = ADMMConfig(lam=LAM, max_iter=MAX_ITER)
    rho = np.asarray(solver.compute_rho(jnp.asarray(X), acfg.h, acfg.kernel,
                                        acfg.rho_safety,
                                        mask=jnp.asarray(mask)))
    want = np.asarray(decsvm_fit_uneven(jnp.asarray(X), jnp.asarray(y),
                                        jnp.asarray(mask), jnp.asarray(W),
                                        acfg))
    ops.reset_launches()
    for backend in ("jnp", "pallas", "megakernel"):
        got = tc.decsvm_fit_uneven(X, y, mask, W, _cfg(backend=backend),
                                   rho=rho, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_lam_weights_beta0_and_lam0_match_jax(fixture):
    _, X, y, W, rho = fixture
    rng = np.random.default_rng(0)
    w = rng.uniform(0.2, 1.0, X.shape[-1]).astype(np.float32)
    B0 = (rng.standard_normal((X.shape[0], X.shape[-1])) * 0.05).astype(
        np.float32)
    acfg = ADMMConfig(lam=LAM, lam0=0.1, max_iter=MAX_ITER)
    want = np.asarray(decsvm_fit(jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(W), acfg, beta0=jnp.asarray(B0),
                                 lam_weights=jnp.asarray(w)))
    for backend in ("jnp", "pallas", "megakernel"):
        got = tc.decsvm_fit(X, y, W, _cfg(lam0=0.1, backend=backend),
                            beta0=B0, lam_weights=w, rho=rho,
                            device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_admm_step_objective_and_threshold_match_jax(fixture, dense):
    _, X, y, W, rho = fixture
    acfg = ADMMConfig(lam=LAM)
    deg = W.sum(1)
    B = dense[1][5]
    P = np.asarray(np.random.default_rng(1).normal(size=B.shape) * 0.01,
                   np.float32)
    js = admm_step(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                   jnp.asarray(deg), jnp.asarray(rho),
                   ADMMState(jnp.asarray(B), jnp.asarray(P),
                             jnp.asarray(0)), acfg)
    tstate = tadmm.ADMMState(torch.tensor(B), torch.tensor(P),
                             torch.tensor(0, dtype=torch.int32))
    t = tadmm.admm_step(torch.tensor(X), torch.tensor(y), torch.tensor(W),
                        torch.tensor(deg), torch.tensor(rho), tstate,
                        tc.ADMMConfig(lam=LAM))
    np.testing.assert_allclose(t.B.numpy(), np.asarray(js.B), atol=ATOL)
    np.testing.assert_allclose(t.P.numpy(), np.asarray(js.P), atol=ATOL)
    assert int(t.t) == 1
    beta = dense[0].mean(0)
    assert float(tc.objective(torch.tensor(X), torch.tensor(y),
                              torch.tensor(beta), tc.ADMMConfig(lam=LAM))) \
        == pytest.approx(float(objective(jnp.asarray(X), jnp.asarray(y),
                                         jnp.asarray(beta), acfg)), abs=1e-6)
    np.testing.assert_array_equal(
        tc.hard_threshold_final(torch.tensor(dense[0]), 0.03).numpy(),
        np.asarray(hard_threshold_final(jnp.asarray(dense[0]), 0.03)))


def test_unported_options_raise(fixture):
    _, X, y, W, rho = fixture
    with pytest.raises(NotImplementedError, match="later slice"):
        tc.decsvm_fit(X, y, W, _cfg(sanitize=True), rho=rho, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tc.decsvm_fit_tol(X, y, W, _cfg(sanitize=True), rho=rho,
                          device="cpu")
    prob = ts.make_problem(torch.tensor(X), torch.tensor(y), torch.tensor(W),
                           _cfg(), rho=torch.tensor(rho))
    step = ts.make_step(_cfg(), lambda B: B)
    with pytest.raises(NotImplementedError, match="sharded"):
        ts.run_tol(step, prob, LAM, max_iter=2, tol=0.0, axis_name="node")
    with pytest.raises(NotImplementedError, match="sharded"):
        ts.kkt_residual_fn(_cfg(), axis_name="node")
    with pytest.raises(ValueError, match="backend"):
        ts.resolve_backend(_cfg(backend="triton"))


def test_default_device_is_cuda(fixture):
    """numpy inputs go to the card by default; with no card the drivers
    raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, X, y, W, rho = fixture
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.decsvm_fit(X, y, W, _cfg(), rho=rho)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tad.decsvm_fit_tol(X, y, W, _cfg(), rho=rho)


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's kernel checks and main-path fits run end to end on
    the CPU at a tiny size (the wrappers take their plain versions; the
    launch counters are fed by a stand-in so that the main-path count
    checks run too)."""
    import chip_smoke

    for name in ops.KERNELS:
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            ops.launches[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    from repro_torch.kernels import csvm_update as cu
    d = chip_smoke.Data(torch, tc, tc.SimConfig(p=30, s=5, m=5, n=24,
                                                rho=0.5), device="cpu")
    devs = {}
    chip_smoke.kernel_checks(torch, ops, cu, d, "tiny", devs)
    assert set(devs) == set(ops.KERNELS)
    # timings: CUDA events stand in for a call that runs the function once
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda torch_, fn, reps, warmup=1: (fn(), 1.0)[1])
    rows = chip_smoke.kernel_timings(torch, ops, cu, d, max_iter=7)
    assert set(rows) == set(ops.KERNELS)
    assert rows["csvm_round_block"]["bound_by"] in ("bytes", "operations")
    # KKT stop at 0.05: both tiny fits reach it at t = 24, before max_iter
    launches = chip_smoke.main_path(torch, tc, ops, d, max_iter=30,
                                    kkt_tol=0.05)
    assert launches == {"csvm_local_update": 30, "csvm_block_update": 30,
                        "csvm_round_block": 1 + 24 // 4}
    assert chip_smoke.ptxas_report(
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118"
        "round_block_kernelIfEEvNS_4ArgsIT_EE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 48 registers, used 1 barriers\n") == [
        ("round_block_kernel<float>", 48,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
