"""Torch port, tuning, baselines and penalties: the port's copies of the
NumPy helpers are bit-equal to the JAX package's; ``modified_bic_jnp``
agrees within 1e-6; on ``tests/test_baselines_tuning.py``'s fixture the
four baselines and the dense LLA fits reproduce JAX's within 1e-5 (the
power-iteration eigenvalue and rho injected from JAX, as in
``tests/test_torch_solver.py``); the LLA weight functions agree to 1e-7.
Everything runs on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (ADMMConfig, SimConfig, baselines, decsvm_fit,
                        generate, sanitize, solver, tuning)
from repro.core import penalties
from repro.core.graph import erdos_renyi
import repro_torch.core as tc
from repro_torch.core import baselines as tbase
from repro_torch.core import penalties as tpen
from repro_torch.core import sanitize as tsan
from repro_torch.core import tuning as ttuning
from _torch_cases import one_thread  # noqa: F401

# fp32 tier: the same fp32 arithmetic in another summation order, through
# up to 1500 FISTA iterations or 400 ADMM rounds (measured <= 2.6e-6)
ATOL = 1e-5


@pytest.fixture(scope="module")
def sim():
    cfg = SimConfig(p=40, s=5, m=6, n=150, rho=0.5)
    X, y, bstar = generate(cfg, seed=11)
    W = erdos_renyi(cfg.m, 0.6, seed=2)
    rho = np.asarray(solver.compute_rho(jnp.asarray(X), 0.25,
                                        "epanechnikov", 1.05))
    return cfg, X, y, bstar, W, rho


@pytest.mark.parametrize("num,min_frac", [(6, 1e-3), (12, 1e-3), (5, 1e-2)])
def test_lambda_grids_are_bit_equal(sim, num, min_frac):
    _, X, y, _, _, _ = sim
    np.testing.assert_array_equal(
        ttuning.lambda_grid(X, y, num=num, min_frac=min_frac),
        tuning.lambda_grid(X, y, num=num, min_frac=min_frac))
    Xs = np.stack([X, X[::-1].copy()])
    ys = np.stack([y, -y])
    np.testing.assert_array_equal(
        ttuning.shared_lambda_grid(Xs, ys, num=num, min_frac=min_frac),
        tuning.shared_lambda_grid(Xs, ys, num=num, min_frac=min_frac))
    assert ttuning._lambda_max(X, y) == tuning._lambda_max(X, y)


@pytest.mark.parametrize("m,n,k,seed", [(6, 150, 5, 0), (4, 80, 3, 7),
                                        (2, 2, 2, 1)])
def test_kfold_masks_are_bit_equal(m, n, k, seed):
    got = ttuning.kfold_masks(m, n, k, seed=seed)
    np.testing.assert_array_equal(got, tuning.kfold_masks(m, n, k, seed=seed))
    assert got.dtype == np.float32
    with pytest.raises(ValueError, match="2 <= k <= n"):
        ttuning.kfold_masks(m, n, n + 1)


def test_modified_bic_numpy_equal_and_torch_within_1e_6(sim):
    cfg, X, y, _, W, rho = sim
    rng = np.random.default_rng(5)
    path = (rng.standard_normal((4, cfg.m, cfg.p + 1)) * 0.1
            * (rng.random((4, cfg.m, cfg.p + 1)) < 0.3)).astype(np.float32)
    for B in path:
        assert ttuning.modified_bic(X, y, B) == tuning.modified_bic(X, y, B)
        want = float(tuning.modified_bic_jnp(jnp.asarray(X), jnp.asarray(y),
                                             jnp.asarray(B)))
        got = ttuning.modified_bic_jnp(torch.tensor(X), torch.tensor(y),
                                       torch.tensor(B))
        assert got.dim() == 0 and float(got) == pytest.approx(want, abs=1e-6)
    # a whole path in one batched product: the per-point values
    crits = ttuning.modified_bic_jnp(torch.tensor(X), torch.tensor(y),
                                     torch.tensor(path))
    assert tuple(crits.shape) == (4,)
    want = [float(tuning.modified_bic_jnp(jnp.asarray(X), jnp.asarray(y),
                                          jnp.asarray(B))) for B in path]
    np.testing.assert_allclose(crits.numpy(), want, atol=1e-6)


def test_select_lambda_matches_jax_with_a_torch_fit(sim):
    """The cold host loop takes a fit returning a tensor and picks JAX's
    lambda, with JAX's table."""
    _, X, y, _, W, rho = sim
    lams = tuning.lambda_grid(X, y, num=6)

    def jfit(lam):
        return decsvm_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                          ADMMConfig(lam=lam, max_iter=200))

    def tfit(lam):
        return tc.decsvm_fit(X, y, W, tc.ADMMConfig(lam=lam, max_iter=200),
                             rho=rho, device="cpu")

    want = tuning.select_lambda(jfit, X, y, lams)
    got = ttuning.select_lambda(tfit, X, y, lams)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=ATOL)
    np.testing.assert_allclose(np.array(got[2]), np.array(want[2]),
                               atol=1e-6)


@pytest.fixture(scope="module")
def lmax(sim):
    """JAX's power-iteration eigenvalues: pooled (scalar) and per node."""
    _, X, _, _, _, _ = sim
    pooled = float(solver.power_iteration_lmax(
        jnp.asarray(X.reshape(-1, X.shape[-1]))))
    local = np.asarray(jax.vmap(solver.power_iteration_lmax)(jnp.asarray(X)))
    return pooled, local


def test_pooled_and_local_fista_match_jax(sim, lmax):
    _, X, y, _, _, _ = sim
    acfg = ADMMConfig(lam=0.06, max_iter=400)
    tcfg = tc.ADMMConfig(lam=0.06, max_iter=400)
    Xp, yp = X.reshape(-1, X.shape[-1]), y.reshape(-1)
    want = np.asarray(baselines.pooled_csvm(jnp.asarray(Xp), jnp.asarray(yp),
                                            acfg, 1500))
    got = tbase.pooled_csvm(Xp, yp, tcfg, 1500, lmax=lmax[0], device="cpu")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    want = np.asarray(baselines.local_csvm(jnp.asarray(X), jnp.asarray(y),
                                           acfg, 800))
    got = tbase.local_csvm(X, y, tcfg, 800, lmax=lmax[1], device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the port's own power iteration: the same estimator, to its rtol
    own = tbase.pooled_csvm(Xp, yp, tcfg, 1500, device="cpu").numpy()
    assert np.max(np.abs(own - np.asarray(baselines.pooled_csvm(
        jnp.asarray(Xp), jnp.asarray(yp), acfg, 1500)))) < 1e-4


def test_consensus_and_dsubgd_match_jax(sim):
    cfg, X, y, _, W, _ = sim
    B = np.random.default_rng(0).standard_normal((cfg.m, 41)).astype(
        np.float32)
    for rounds in (100, 400):
        want = np.asarray(baselines.average_consensus(jnp.asarray(B), W,
                                                      rounds=rounds))
        got = tbase.average_consensus(B, W, rounds=rounds, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    want = np.asarray(baselines.d_subgd_fit(jnp.asarray(X), jnp.asarray(y),
                                            W, lam=0.05, max_iter=200))
    got = tbase.d_subgd_fit(X, y, W, lam=0.05, max_iter=200, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", ["scad", "mcp", "adaptive"])
def test_lla_weight_functions_match_jax(name):
    beta = np.linspace(-0.6, 0.6, 241).astype(np.float32)
    for lam in (0.01, 0.06, 0.3):
        want = np.asarray(penalties.PENALTIES[name](jnp.asarray(beta), lam))
        got = tpen.PENALTIES[name](torch.tensor(beta), lam)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    kw = {"scad": dict(a=3.0), "mcp": dict(gamma=2.0),
          "adaptive": dict(eps=0.1, power=2.0)}[name]
    want = np.asarray(penalties.PENALTIES[name](jnp.asarray(beta), 0.06, **kw))
    got = tpen.PENALTIES[name](torch.tensor(beta), 0.06, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("backend", ["jnp", "megakernel"])
@pytest.mark.parametrize("penalty", ["scad", "mcp", "adaptive"])
def test_lla_fit_matches_jax(sim, penalty, backend):
    """Stage 1 at cfg.lam, stage 2 with the per-coordinate weights (one
    round-kernel launch with a (p,) lam_vec under the megakernel)."""
    _, X, y, _, W, rho = sim
    jB, jw = penalties.decsvm_fit_lla(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
        ADMMConfig(lam=0.06, max_iter=400), penalty=penalty)
    B, w = tpen.decsvm_fit_lla(
        X, y, W, tc.ADMMConfig(lam=0.06, max_iter=400, backend=backend),
        penalty=penalty, rho=rho, device="cpu")
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), atol=ATOL)


@pytest.mark.parametrize("path_mode", ["batched", "warm"])
def test_lla_with_a_path_pilot_matches_jax(path_mode):
    """``lams`` given: the BIC-selected lambda of the path is the pilot and
    the stage-2 level (``tests/test_path.py``'s fixture)."""
    cfg = SimConfig(p=24, s=4, m=4, n=80, rho=0.5, mu=0.5)
    X, y, _ = generate(cfg, seed=3)
    W = np.asarray(erdos_renyi(cfg.m, 0.7, seed=1), np.float32)
    lams = tuning.lambda_grid(X, y, num=5)
    rho = np.asarray(solver.compute_rho(jnp.asarray(X), 0.25,
                                        "epanechnikov", 1.05))
    jB, jw = penalties.decsvm_fit_lla(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
        ADMMConfig(lam=0.0, max_iter=150), penalty="scad", lams=lams,
        path_mode=path_mode)
    B, w = tpen.decsvm_fit_lla(
        X, y, W, tc.ADMMConfig(lam=0.0, max_iter=150, backend="megakernel"),
        penalty="scad", lams=lams, path_mode=path_mode, rho=rho,
        device="cpu")
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), atol=ATOL)


def test_sanitize_gate_and_unported_engines_raise(sim):
    _, X, y, _, W, rho = sim
    on = tc.ADMMConfig(sanitize=True)
    assert tsan.wants_sanitize(on) and not tsan.wants_sanitize(object())
    with pytest.raises(NotImplementedError) as got:
        tsan.reject_unsupported(on, "decsvm_path_select")
    with pytest.raises(NotImplementedError) as want:
        sanitize.reject_unsupported(ADMMConfig(sanitize=True),
                                    "decsvm_path_select")
    assert str(got.value) == str(want.value)
    tsan.reject_unsupported(tc.ADMMConfig(), "decsvm_path_select")
    cfg = tc.ADMMConfig(lam=0.06, max_iter=5)
    from repro_torch.launch.mesh import Mesh
    with pytest.raises(ValueError, match="ranks"):
        tpen.decsvm_fit_lla(X, y, W, cfg, engine="sharded",
                            mesh=Mesh((("node", 2),)), device="cpu")
    for engine in ("mesh", "ring"):
        with pytest.raises(ValueError, match="engine"):
            tpen.decsvm_fit_lla(X, y, W, cfg, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="penalty"):
        tpen.decsvm_fit_lla(X, y, W, cfg, penalty="l0", device="cpu")
    if not torch.cuda.is_available():
        for fn in (lambda: tpen.decsvm_fit_lla(X, y, W, cfg),
                   lambda: tbase.local_csvm(X, y, cfg, 5),
                   lambda: tbase.d_subgd_fit(X, y, W, max_iter=2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


def test_quickstart_rows_on_the_cpu():
    """``python3 -m repro_torch.launch.quickstart --device cpu``: the six
    rows, deCSVM and Tuned recovering the support, Local the worst."""
    from repro_torch.launch import quickstart
    lines = []
    rows = quickstart.run("cpu", log=lambda *a: lines.append(" ".join(
        map(str, a))))
    assert list(rows) == list(quickstart.ROWS)
    for name in ("deCSVM", "Tuned", "Pooled"):
        assert rows[name]["f1"] >= 0.9, (name, rows[name])
    assert rows["Local"]["est_err"] > rows["deCSVM"]["est_err"]
    assert rows["D-subGD"]["supp"] > rows["deCSVM"]["supp"]
    assert len(rows["Tuned"]["iters"]) == 12
    assert any(line.startswith("Tuned") for line in lines)
