"""Torch port on the card: each CUDA kernel against its plain torch version,
and the port's fits through the kernels against the plain backend.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the CUDA kernels have no CPU mode).  The file imports no jax, so
it also runs where only the port's dependencies are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.graph import ring
from repro_torch.kernels import csvm_update as cu
from repro_torch.kernels import ops

from _torch_cases import ROUND_CASES, problem

pytestmark = pytest.mark.cuda

# fp32: the same fp32 arithmetic summed in another order on the card
ATOL = 1e-5
# bf16 kernel against its plain version: both round B, w and beta_bar to
# bf16 at the same points, so they differ only where an fp32 summation-order
# difference moves an operand across a bf16 rounding boundary.  One such
# flip moves B+ by about |b| 2^-8 omega c_h lmax(X'X/n) ~ |b| / 2400 at
# |b| ~ 0.05: 2e-5 (measured 2.2e-5 at X (16, 1024, 4096), 5 rounds + KKT,
# in chip_smoke.py); the limit holds a few flips.
ATOL_BF16_KERNEL = 1e-4
# a bf16 fit against the fp32 plain fit: the repo's bf16 tier
ATOL_BF16 = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(d, dev):
    return {k: torch.tensor(v, device=dev) for k, v in d.items()}


def _close(got, want, tol):
    if want.dim() == 0 and torch.isinf(want):
        assert torch.isinf(got) and float(got) > 0
    else:
        torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37, 130), (16, 64, 4096)])
def test_block_update_matches_plain(cuda, dtype, shape):
    t = _on(problem(*shape, seed=3), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["neigh"], t["rho"],
            t["omega"], t["lam"])
    before = ops.launches["csvm_block_update"]
    got = ops.csvm_block_update(*args, h=0.3)
    assert ops.launches["csvm_block_update"] == before + 1
    want = cu.csvm_block_update_plain(*args, h=0.3)
    _close(got, want, ATOL if dtype == torch.float32 else ATOL_BF16_KERNEL)


@pytest.mark.parametrize("kernel", ["epanechnikov", "laplacian", "gaussian",
                                    "uniform", "logistic"])
def test_local_update_matches_plain(cuda, kernel):
    t = _on(problem(4, 29, 70, seed=4), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"],
            t["omega"], t["lam"])
    before = ops.launches["csvm_local_update"]
    got = ops.csvm_local_update(*args, h=0.3, kernel=kernel)
    one = ops.csvm_local_update(*(a[0] for a in args[:7]), t["lam"], h=0.3,
                                kernel=kernel)
    assert ops.launches["csvm_local_update"] == before + 2
    want = cu.csvm_local_update_plain(*args, h=0.3, kernel=kernel)
    _close(got, want, ATOL)
    _close(one, want[0], ATOL)


@pytest.mark.parametrize("case", ROUND_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_block_matches_plain(cuda, case, dtype):
    m, n, p, R, nact, kkt, lam0, _, kernel = case
    t = _on(problem(m, n, p, seed=m + n + p), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["W"], t["deg"],
            t["rho"], t["omega"], t["lam"])
    kw = dict(tau=1.0, lam0=lam0, h=0.35, kernel=kernel, num_rounds=R,
              want_kkt=kkt)
    before = ops.launches["csvm_round_block"]
    got = ops.csvm_round_block(
        *args, torch.tensor(nact, dtype=torch.int32, device=cuda), **kw)
    assert ops.launches["csvm_round_block"] == before + 1
    want = cu.csvm_round_block_plain(*args, nact, **kw)
    for g, w in zip(got, want):
        _close(g, w, ATOL if dtype == torch.float32 else ATOL_BF16_KERNEL)
    if nact == 0:
        assert torch.equal(got[0], t["B"]) and torch.equal(got[1], t["P"])


def test_round_block_is_deterministic(cuda):
    t = _on(problem(6, 50, 300, seed=9), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["W"], t["deg"], t["rho"],
            t["omega"], t["lam"], torch.tensor(7, dtype=torch.int32,
                                               device=cuda))
    kw = dict(tau=1.0, lam0=0.0, h=0.3, num_rounds=7, want_kkt=True)
    a, b = ops.csvm_round_block(*args, **kw), ops.csvm_round_block(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrappers_raise_on_bad_operands(cuda):
    t = _on(problem(2, 5, 4), cuda)
    args = [t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"], t["omega"],
            t["lam"]]
    with pytest.raises(TypeError):
        ops.csvm_block_update(t["X"].double(), *args[1:], h=0.3)
    with pytest.raises(ValueError):
        ops.csvm_block_update(args[0], t["y"].cpu(), *args[2:], h=0.3)
    with pytest.raises(TypeError):
        ops.csvm_local_update(t["X"].bfloat16(), *args[1:], h=0.3)
    assert ops.megakernel_supported(2, 5, 4, torch.float32, device=cuda)
    assert not ops.megakernel_supported(10**4, 10**4, 10**4, torch.float32,
                                        device=cuda)


@pytest.mark.parametrize("backend", ["pallas", "megakernel",
                                     "megakernel_bf16"])
def test_fit_through_the_kernels_matches_the_plain_fit(cuda, backend):
    sim = tc.SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = tc.generate(sim, seed=1)
    W = ring(sim.m)
    cfg = lambda b: tc.ADMMConfig(lam=0.05, max_iter=60, backend=b)
    ops.reset_launches()
    got = tc.decsvm_fit(X, y, W, cfg(backend))
    assert got.is_cuda and sum(ops.launches.values()) >= 1
    want = tc.decsvm_fit(X, y, W, cfg("jnp"))
    tol = ATOL_BF16 if backend == "megakernel_bf16" else ATOL
    _close(got, want, tol)
    Bt, t = tc.decsvm_fit_tol(X, y, W, cfg(backend), tol=-1.0,
                              stop_rule="kkt", check_every=7)
    assert int(t) == 60
    _close(Bt, want, tol)


def test_refused_round_block_loops_the_block_update_kernel(cuda,
                                                           monkeypatch):
    """When the residency rule refuses the round kernel, the megakernel fit
    runs one csvm_block_update launch per round and never the plain
    ``local_update`` on the card."""
    from repro_torch.core import solver
    sim = tc.SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = tc.generate(sim, seed=1)
    W = ring(sim.m)
    cfg = lambda b: tc.ADMMConfig(lam=0.05, max_iter=60, backend=b)
    want = tc.decsvm_fit(X, y, W, cfg("jnp"))
    monkeypatch.setattr(ops, "megakernel_supported", lambda *a, **k: False)

    def no_reference(*a, **k):
        raise AssertionError("the megakernel backend reached local_update")
    monkeypatch.setattr(solver, "local_update", no_reference)
    ops.reset_launches()
    got = tc.decsvm_fit(X, y, W, cfg("megakernel"))
    assert ops.launches["csvm_block_update"] == 60
    assert ops.launches["csvm_round_block"] == 0
    _close(got, want, ATOL)
