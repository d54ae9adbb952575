"""Torch port, the sanitizer (``ADMMConfig(sanitize=True)``,
``repro_torch.core.sanitize``), mirroring ``tests/test_sanitize.py``:

1. **Off is untouched**: with ``sanitize=False`` every driver runs the
   unchecked step — the same bits as a config predating the flag, the
   same kernel launches, and ``round_block`` still attached.
2. **Localization on**: each E1-E7 check fires on the input that poisons
   exactly its term, with JAX's message for the same term and round (JAX
   adds " (`check` failed)"); the first failing check wins.
3. **Fail-fast elsewhere**: the lambda-grid drivers, the decentralized
   engines and fit serving reject sanitize configs with JAX's message.

Clean sanitized fits are also held to JAX's sanitized fits (JAX's rho
injected, fp32 within 1e-5).  Everything runs on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from repro.core import ADMMConfig
from repro.core import decsvm_fit as jfit
from repro.core import sanitize as jsan
from repro.core import solver as jsolver
from repro.core.admm_adaptive import decsvm_fit_tol as jfit_tol
from repro.core.admm_adaptive import decsvm_fit_uneven as jfit_uneven
from repro.core.graph import ring
import repro_torch.core as tc
from repro_torch.core import decentral as tdec
from repro_torch.core import path as tpath
from repro_torch.core import sanitize as tsan
from repro_torch.core import solver as ts
from repro_torch.kernels import ops
from _torch_cases import one_thread  # noqa: F401

M, N, P = 4, 12, 8
ITERS = 6
LAM = 0.05
ATOL = 1e-5


@dataclasses.dataclass(frozen=True)
class LegacyCfg:
    """``ADMMConfig`` as it was before the ``sanitize`` field — the
    duck-typed stand-in ``wants_sanitize`` must treat as False."""
    lam: float = 0.05
    lam0: float = 0.0
    tau: float = 1.0
    h: float = 0.25
    kernel: str = "epanechnikov"
    max_iter: int = 300
    rho_safety: float = 1.05
    use_pallas: bool = False
    backend: str = "auto"


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(M, N, P)).astype(np.float32)
    beta = rng.normal(size=(P,))
    y = np.sign(X @ beta + 0.1).astype(np.float32)
    return X, y


X0, Y0 = _data()
W0 = np.asarray(ring(M), np.float32)
MASK = np.ones((M, N), np.float32)
LAMS = np.asarray([2 * LAM, LAM], np.float32)
RHO = np.asarray(jsolver.compute_rho(jnp.asarray(X0), 0.25, "epanechnikov",
                                     1.05))
ON = dict(rho=RHO, device="cpu")


def _recipes(mk):
    """The drivers of ``tests/test_sanitize.py``'s parity matrix that
    accept a config, parameterized by a config factory."""
    a = mk(lam=LAM, max_iter=ITERS)
    pal = mk(lam=LAM, max_iter=ITERS, use_pallas=True)
    pz = mk(lam=0.0, max_iter=ITERS)
    mkc = mk(lam=LAM, max_iter=ITERS, backend="megakernel")
    mkz = mk(lam=0.0, max_iter=ITERS, backend="megakernel")
    b16 = mk(lam=LAM, max_iter=ITERS, backend="megakernel_bf16")
    tol = dict(tol=1e-6, stop_rule="kkt", check_every=2)
    return {
        "dense": lambda X, y: tc.decsvm_fit(X, y, W0, a, **ON),
        "pallas": lambda X, y: tc.decsvm_fit(X, y, W0, pal, **ON),
        "tol": lambda X, y: tc.decsvm_fit_tol(X, y, W0, a, **tol, **ON)[0],
        "uneven": lambda X, y: tc.decsvm_fit_uneven(X, y, MASK, W0, a, **ON),
        "path-batched": lambda X, y: tpath.decsvm_path_batched(
            X, y, W0, LAMS, pz, **ON),
        "path-warm": lambda X, y: tpath.decsvm_path_warm(
            X, y, W0, LAMS, pz, **tol, **ON)[0],
        "sharded-gather": lambda X, y: tdec.decsvm_fit_sharded(
            X, y, W0, a, schedule="gather", **ON),
        "sharded-ring": lambda X, y: tdec.decsvm_fit_sharded(
            X, y, W0, a, schedule="ring", **ON),
        "mesh-2d": lambda X, y: tdec.decsvm_path_mesh(
            X, y, W0, LAMS, pz, mode="batched", **ON).path,
        "megakernel": lambda X, y: tc.decsvm_fit(X, y, W0, mkc, **ON),
        "megakernel-tol": lambda X, y: tc.decsvm_fit_tol(
            X, y, W0, mkc, **tol, **ON)[0],
        "megakernel-path-warm": lambda X, y: tpath.decsvm_path_warm(
            X, y, W0, LAMS, mkz, **tol, **ON)[0],
        "mesh-2d-megakernel": lambda X, y: tdec.decsvm_path_mesh(
            X, y, W0, LAMS, mkz, mode="batched", **ON).path,
        "megakernel-bf16": lambda X, y: tc.decsvm_fit(X, y, W0, b16, **ON),
    }


def _counted(monkeypatch):
    """Stand-in counters: each wrapper call counts as one launch."""
    for name in ("csvm_round_block", "csvm_block_update",
                 "csvm_local_update"):
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            ops.launches[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    ops.reset_launches()


def _launches():
    return {k: ops.launches[k] for k in ("csvm_round_block",
                                         "csvm_block_update",
                                         "csvm_local_update")}


# -- claim 1: sanitize=False is the untouched step ----------------------------


@pytest.mark.parametrize("name", sorted(_recipes(tc.ADMMConfig)))
def test_sanitize_false_runs_the_untouched_program(name, monkeypatch):
    """Every driver under ``ADMMConfig(sanitize=False)`` gives the same
    bits, with the same kernel launches, as under a config class that
    predates the flag."""
    _counted(monkeypatch)
    new = _recipes(lambda **kw: tc.ADMMConfig(sanitize=False, **kw))[name]
    old = _recipes(lambda **kw: LegacyCfg(**kw))[name]
    got = new(X0, Y0)
    launches = _launches()
    ops.reset_launches()
    want = old(X0, Y0)
    assert torch.equal(got, want)
    assert launches == _launches()


@pytest.mark.parametrize("backend", ["megakernel", "megakernel_bf16"])
def test_round_block_attached_only_without_sanitize(backend):
    W = torch.tensor(W0)
    off = ts.make_step(tc.ADMMConfig(backend=backend), lambda B: W @ B, W=W)
    assert callable(off.round_block) and callable(off.cached_round)
    on = ts.make_step(tc.ADMMConfig(backend=backend, sanitize=True),
                      lambda B: W @ B, W=W)
    assert not hasattr(on, "round_block")
    assert not hasattr(on, "cached_round")
    fn = ts.kkt_residual_fn(tc.ADMMConfig(sanitize=True))
    assert getattr(fn, "kind", None) == "kkt"


def test_sanitized_megakernel_fit_loops_the_block_update(monkeypatch):
    """Under sanitize the round kernel is not attached: a megakernel fit is
    one two-pass launch a round, and equals the one-launch fit."""
    _counted(monkeypatch)
    cfg = tc.ADMMConfig(lam=LAM, max_iter=ITERS, backend="megakernel")
    B = tc.decsvm_fit(X0, Y0, W0, cfg, **ON)
    assert _launches() == {"csvm_round_block": 1, "csvm_block_update": 0,
                           "csvm_local_update": 0}
    ops.reset_launches()
    Bs = tc.decsvm_fit(X0, Y0, W0, dataclasses.replace(cfg, sanitize=True),
                       **ON)
    assert _launches() == {"csvm_round_block": 0,
                           "csvm_block_update": ITERS,
                           "csvm_local_update": 0}
    np.testing.assert_allclose(Bs.numpy(), B.numpy(), atol=1e-6)


# -- clean-path equivalence --------------------------------------------------


def test_sanitized_fit_matches_unsanitized_and_jax_on_clean_data():
    cfg = tc.ADMMConfig(lam=LAM, max_iter=ITERS)
    cfg_s = dataclasses.replace(cfg, sanitize=True)
    acfg_s = ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    jX, jy, jW = jnp.asarray(X0), jnp.asarray(Y0), jnp.asarray(W0)

    B = tc.decsvm_fit(X0, Y0, W0, cfg, **ON)
    Bs = tc.decsvm_fit(X0, Y0, W0, cfg_s, **ON)
    np.testing.assert_allclose(Bs.numpy(), B.numpy(), rtol=1e-6)
    np.testing.assert_allclose(Bs.numpy(), np.asarray(jfit(jX, jy, jW,
                                                           acfg_s)),
                               atol=ATOL)

    tol = dict(tol=1e-6, stop_rule="kkt", check_every=2)
    Bt, t = tc.decsvm_fit_tol(X0, Y0, W0, cfg, **tol, **ON)
    Bts, t_s = tc.decsvm_fit_tol(X0, Y0, W0, cfg_s, **tol, **ON)
    np.testing.assert_allclose(Bts.numpy(), Bt.numpy(), rtol=1e-6)
    jB, jt = jfit_tol(jX, jy, jW, acfg_s, **tol)
    assert int(t_s) == int(t) == int(jt)
    np.testing.assert_allclose(Bts.numpy(), np.asarray(jB), atol=ATOL)

    Bu = tc.decsvm_fit_uneven(X0, Y0, MASK, W0, cfg, **ON)
    Bus = tc.decsvm_fit_uneven(X0, Y0, MASK, W0, cfg_s, **ON)
    np.testing.assert_allclose(Bus.numpy(), Bu.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        Bus.numpy(), np.asarray(jfit_uneven(jX, jy, jnp.asarray(MASK), jW,
                                            acfg_s)), atol=ATOL)


def test_sanitized_bf16_fit_runs_the_per_round_path_clean():
    cfg_s = tc.ADMMConfig(lam=LAM, max_iter=ITERS, backend="megakernel_bf16",
                          sanitize=True)
    B = tc.decsvm_fit(X0, Y0, W0, cfg_s, **ON)
    assert np.all(np.isfinite(B.numpy()))


# -- claim 2: E1-E7 localization ----------------------------------------------


def _jax_message(fn):
    with pytest.raises(checkify.JaxRuntimeError) as err:
        fn()
    return str(err.value)


def _same_failure(port_fn, jax_fn, code):
    """The port raises ``code`` with JAX's message for the same term and
    round (JAX appends " (`check` failed)")."""
    with pytest.raises(tsan.SanitizerError, match=code) as err:
        port_fn()
    assert _jax_message(jax_fn).startswith(str(err.value))
    return err.value


def _fit_pair(X, y, W, **cfg_kw):
    cfg = tc.ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True, **cfg_kw)
    acfg = ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True, **cfg_kw)
    return (lambda: tc.decsvm_fit(X, y, W, cfg, **ON),
            lambda: jfit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                         acfg))


@pytest.mark.parametrize("backend", ["jnp", "megakernel"])
def test_e1_nan_label_localizes_to_margin_weights_at_round_0(backend):
    y = Y0.copy()
    y[1, 3] = np.nan
    err = _same_failure(*_fit_pair(X0, y, W0, backend=backend),
                        r"E1:.*margin weight.*round 0")
    assert (err.code, err.round) == ("E1", 0)


@pytest.mark.parametrize("backend", ["jnp", "megakernel"])
def test_e3_nan_adjacency_localizes_to_neighbour_sum(backend):
    W = W0.copy()
    W[0, 1] = np.nan
    _same_failure(*_fit_pair(X0, Y0, W, backend=backend),
                  r"E3:.*neighbour sum.*round 0")


def test_e4_nan_dual_poisons_primal_update_and_reports_round_index():
    cfg_s = tc.ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    W = torch.tensor(W0)
    prob = ts.make_problem(torch.tensor(X0), torch.tensor(Y0), W, cfg_s,
                           rho=torch.tensor(RHO))
    step = ts.make_step(cfg_s, lambda B: W @ B, W=W)
    state = ts.init_state(prob, P0=torch.full((M, P), float("nan")))
    state = state._replace(t=torch.tensor(5, dtype=torch.int32))

    acfg_s = ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    jW = jnp.asarray(W0)
    jprob = jsolver.make_problem(jnp.asarray(X0), jnp.asarray(Y0), jW,
                                 acfg_s)
    jstep = jsolver.make_step(acfg_s, lambda B: jW @ B, W=jW)
    jstate = jsolver.init_state(jprob, P0=jnp.full((M, P), jnp.nan))
    jstate = jstate._replace(t=jnp.asarray(5, jnp.int32))

    def jax_fn():
        err, _ = checkify.checkify(lambda s: jstep(jprob, s, LAM, None),
                                   errors=jsan.USER_CHECKS)(jstate)
        err.throw()

    _same_failure(lambda: step(prob, state, LAM), jax_fn,
                  r"E4:.*primal update.*round 5")


def _stub_step(field, value):
    def stub(prob, state, lam, lam_weights=None):
        return state._replace(**{field: torch.full_like(state.B, value)},
                              t=state.t + 1)
    return stub


def test_e5_bf16_overflow_window_is_caught_before_the_cast_saturates():
    cfg_s = tc.ADMMConfig(lam=LAM, max_iter=ITERS, backend="megakernel_bf16",
                          sanitize=True)
    W = torch.tensor(W0)
    prob = ts.make_problem(torch.tensor(X0), torch.tensor(Y0), W, cfg_s,
                           rho=torch.tensor(RHO))
    assert prob.X.dtype == torch.bfloat16
    big = tsan.BF16_MAX * 1.001                       # finite in fp32
    step = tsan.checked_step(_stub_step("B", big), cfg_s, lambda B: W @ B)
    with pytest.raises(tsan.SanitizerError,
                       match=r"E5:.*bf16 range.*round 0"):
        step(prob, ts.init_state(prob), LAM)
    # an fp32 X has no E5 check: the same iterate passes
    prob32 = prob._replace(X=prob.X.float())
    step(prob32, ts.init_state(prob32), LAM)


def test_e6_nan_dual_accumulator_is_named():
    cfg_s = tc.ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    W = torch.tensor(W0)
    prob = ts.make_problem(torch.tensor(X0), torch.tensor(Y0), W, cfg_s,
                           rho=torch.tensor(RHO))
    step = tsan.checked_step(_stub_step("P", float("nan")), cfg_s,
                             lambda B: W @ B)
    with pytest.raises(tsan.SanitizerError,
                       match=r"E6:.*dual accumulator.*round 0"):
        step(prob, ts.init_state(prob), LAM)


def test_e7_kkt_statistic_check_wraps_residual_and_keeps_kind():
    cfg_s = tc.ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    fn = ts.kkt_residual_fn(cfg_s)
    assert getattr(fn, "kind", None) == "kkt"
    W = torch.tensor(W0)
    prob = ts.make_problem(torch.tensor(X0), torch.tensor(Y0), W, cfg_s,
                           rho=torch.tensor(RHO))
    state = ts.init_state(prob, B0=torch.full((M, P), float("nan")))

    acfg_s = ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    jfn = jsolver.kkt_residual_fn(acfg_s)
    jprob = jsolver.make_problem(jnp.asarray(X0), jnp.asarray(Y0),
                                 jnp.asarray(W0), acfg_s)
    jstate = jsolver.init_state(jprob, B0=jnp.full((M, P), jnp.nan))

    def jax_fn():
        err, _ = checkify.checkify(lambda s: jfn(jprob, s, LAM, None),
                                   errors=jsan.USER_CHECKS)(jstate)
        err.throw()

    _same_failure(lambda: fn(prob, state, LAM, None), jax_fn,
                  r"E7:.*KKT stop statistic.*round 0")


def test_e7_fires_inside_the_tol_driver_on_the_first_check():
    """E7 inside ``run_tol``: a residual that returns NaN is caught at the
    first check, after the block's two clean rounds, as round 2."""
    cfg_s = tc.ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    W = torch.tensor(W0)
    prob = ts.make_problem(torch.tensor(X0), torch.tensor(Y0), W, cfg_s,
                           rho=torch.tensor(RHO))
    step = ts.make_step(cfg_s, lambda B: W @ B, W=W)
    nan = tsan.checked_residual(lambda *a: torch.tensor(float("nan")),
                                cfg_s)
    with pytest.raises(tsan.SanitizerError, match=r"E7:.*round 2"):
        ts.run_tol(step, prob, LAM, max_iter=ITERS, tol=1e-9,
                   residual_fn=nan, check_every=2)


def test_first_failing_check_wins_when_everything_is_poisoned():
    # NaN X poisons E1 (margins) before E2/E4 — the earliest term is named
    X = X0.copy()
    X[0, 0, 0] = np.nan
    _same_failure(*_fit_pair(X, Y0, W0), r"E1:")


# -- claim 3: unsupported engines fail fast ----------------------------------


def test_sharded_mesh_grid_and_serving_engines_reject_sanitize():
    cfg_s = tc.ADMMConfig(lam=LAM, max_iter=ITERS, sanitize=True)
    calls = {
        "decsvm_fit_sharded": lambda: tdec.decsvm_fit_sharded(
            X0, Y0, W0, cfg_s, **ON),
        "decsvm_fit_chunked": lambda: tdec.decsvm_fit_chunked(
            X0, Y0, W0, cfg_s, **ON),
        "decsvm_path_sharded": lambda: tdec.decsvm_path_sharded(
            X0, Y0, W0, LAMS, cfg_s, **ON),
        "decsvm_path_chunked": lambda: tdec.decsvm_path_chunked(
            X0, Y0, W0, LAMS, cfg_s, **ON),
        "decsvm_path_mesh": lambda: tdec.decsvm_path_mesh(
            X0, Y0, W0, [LAM], cfg_s, mode="batched", **ON),
        "decsvm_path_batched": lambda: tpath.decsvm_path_batched(
            X0, Y0, W0, LAMS, cfg_s, **ON),
        "decsvm_path_select": lambda: tpath.decsvm_path_select(
            X0, Y0, W0, LAMS, cfg_s, **ON),
        "decsvm_path_warm": lambda: tpath.decsvm_path_warm(
            X0, Y0, W0, LAMS, cfg_s, **ON),
    }
    for where, call in calls.items():
        with pytest.raises(NotImplementedError) as got:
            call()
        with pytest.raises(NotImplementedError) as want:
            jsan.reject_unsupported(ADMMConfig(sanitize=True), where)
        assert str(got.value) == str(want.value)
    from repro_torch.serving import DecsvmFitServer, FitRequest
    with pytest.raises(NotImplementedError,
                       match="DecsvmFitServer.submit.*sanitize"):
        DecsvmFitServer(device="cpu").submit(
            FitRequest(rid=0, X=X0, y=Y0, W=W0, cfg=cfg_s))


def test_rejection_message_names_the_supported_dense_drivers():
    cfg_s = tc.ADMMConfig(sanitize=True)
    with pytest.raises(NotImplementedError, match="decsvm_fit_tol"):
        tpath.decsvm_fit_many(X0[None], Y0[None], W0[None], [LAM], cfg_s,
                              device="cpu")
