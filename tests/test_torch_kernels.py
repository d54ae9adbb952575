"""Torch port, kernels: each kernel's plain version (what the wrappers run
on CPU tensors) against the JAX package's Pallas kernel (interpret mode)
and its oracle, the port's oracles against the JAX oracles, the wrapper
checks and the residency rule's byte count.  The CUDA kernels themselves
run only on a card: their tests are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import csvm_update as cu
from repro_torch.kernels import ops, ref

from _torch_cases import ROUND_CASES, problem as _problem

# fp32: the same chain of fp32 dots in another summation order (XLA on
# the CPU vs torch) — the repo's fp32 tier.
ATOL = 1e-5
# bf16 (X and the dot operands rounded to bf16, fp32 accumulation): the
# two sides round the same values at the same points, so they differ only
# where an fp32 summation-order difference moves an operand across a bf16
# rounding boundary; the limit holds a few such flips (the same limit as
# the CUDA kernels against their plain versions, test_torch_cuda.py).
ATOL_BF16_KERNEL = 1e-4
# support for the sign-exact check: |B| above the repo's bf16 tier
ATOL_BF16 = 1e-2


def _close(got, want, tol):
    """allclose, with the +inf progress of a launch with no active round
    matched exactly."""
    if np.ndim(want) == 0 and np.isinf(want):
        assert np.isinf(got) and got > 0 and want > 0
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("n,p,kernel", [(13, 37, "epanechnikov"),
                                        (64, 200, "laplacian"),
                                        (30, 129, "gaussian"),
                                        (9, 5, "logistic"),
                                        (40, 70, "uniform")])
def test_local_update_plain_matches_pallas_and_oracles(n, p, kernel):
    """Ragged n and p, a per-coordinate lambda, one node at a time (as
    JAX vmaps it) and as a node stack (the port's grid axis)."""
    d = _problem(3, n, p, seed=n + p)
    t, j = _t(d), _j(d)
    stacked = ops.csvm_local_update(t["X"], t["y"], t["B"], t["P"],
                                    t["neigh"], t["rho"], t["omega"],
                                    t["lam"], h=0.3, kernel=kernel).numpy()
    for l in range(3):
        args = lambda s: (s["X"][l], s["y"][l], s["B"][l], s["P"][l],
                          s["neigh"][l], s["rho"][l], s["omega"][l],
                          s["lam"])
        want = np.asarray(jops.csvm_local_update(*args(j), h=0.3,
                                                 kernel=kernel))
        got = ops.csvm_local_update(*args(t), h=0.3, kernel=kernel).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(stacked[l], want, atol=ATOL)
        oracle_j = np.asarray(jref.decsvm_local_update(*args(j), h=0.3,
                                                       kernel=kernel))
        oracle_t = ref.decsvm_local_update(*args(t), h=0.3,
                                           kernel=kernel).numpy()
        np.testing.assert_allclose(oracle_t, oracle_j, atol=ATOL)
        np.testing.assert_allclose(got, oracle_t, atol=ATOL)
    # a scalar lambda is the constant vector
    l0 = float(d["lam"][0])
    a = ops.csvm_local_update(t["X"], t["y"], t["B"], t["P"], t["neigh"],
                              t["rho"], t["omega"], l0, h=0.3, kernel=kernel)
    b = ops.csvm_local_update(t["X"], t["y"], t["B"], t["P"], t["neigh"],
                              t["rho"], t["omega"],
                              torch.full((p,), l0), h=0.3, kernel=kernel)
    assert torch.equal(a, b)


@pytest.mark.parametrize("m,n,p", [(5, 13, 37), (3, 16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_update_plain_matches_pallas(m, n, p, dtype):
    d = _problem(m, n, p, seed=m * n)
    t, j = _t(d), _j(d)
    tdt = getattr(torch, dtype)
    want = np.asarray(jops.csvm_block_update(
        j["X"].astype(getattr(jnp, dtype)), j["y"], j["B"], j["P"],
        j["neigh"], j["rho"], j["omega"], j["lam"], h=0.3,
        kernel="epanechnikov"))
    got = ops.csvm_block_update(
        t["X"].to(tdt), t["y"], t["B"], t["P"], t["neigh"], t["rho"],
        t["omega"], t["lam"], h=0.3, kernel="epanechnikov").numpy()
    assert got.dtype == np.float32
    tol = ATOL if dtype == "float32" else ATOL_BF16_KERNEL
    np.testing.assert_allclose(got, want, atol=tol)
    if dtype == "float32":     # and the fp32 kernel is exactly the update
        oracle = ref.decsvm_round_block(
            t["X"], t["y"], t["B"], t["P"], t["W"], t["deg"], t["rho"],
            t["omega"], t["lam"], 1, tau=1.0, lam0=0.0, h=0.3)[0]
        np.testing.assert_allclose(got, oracle.numpy(), atol=ATOL)


@pytest.mark.parametrize("case", ROUND_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_block_plain_matches_pallas_and_oracle(case, dtype):
    m, n, p, R, nact, kkt, lam0, lam_vector, kernel = case
    d = _problem(m, n, p, seed=m + n + p)
    if not lam_vector:
        d["lam"] = np.full(p, 0.01, np.float32)
    t, j = _t(d), _j(d)
    kw = dict(tau=1.0, lam0=lam0, h=0.35, kernel=kernel, num_rounds=R,
              want_kkt=kkt)
    want = jops.csvm_round_block(
        j["X"].astype(getattr(jnp, dtype)), j["y"], j["B"], j["P"], j["W"],
        j["deg"], j["rho"], j["omega"], j["lam"], nact, **kw)
    got = ops.csvm_round_block(
        t["X"].to(getattr(torch, dtype)), t["y"], t["B"], t["P"], t["W"],
        t["deg"], t["rho"], t["omega"], t["lam"],
        torch.tensor(nact, dtype=torch.int32), **kw)
    tol = ATOL if dtype == "float32" else ATOL_BF16_KERNEL
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), tol)
    if nact == 0:                                  # held rounds are no-ops
        assert torch.equal(got[0], t["B"]) and torch.equal(got[1], t["P"])
    if dtype == "bfloat16":                        # sign-exact support
        Bj = np.asarray(want[0])
        supp = np.abs(Bj) > ATOL_BF16
        np.testing.assert_array_equal(np.sign(got[0].numpy())[supp],
                                      np.sign(Bj)[supp])
    else:                                          # and the fp32 oracles
        oj = jref.decsvm_round_block(
            j["X"], j["y"], j["B"], j["P"], j["W"], j["deg"], j["rho"],
            j["omega"], j["lam"], nact, tau=1.0, lam0=lam0, h=0.35,
            kernel=kernel, want_kkt=kkt)
        ot = ref.decsvm_round_block(
            t["X"], t["y"], t["B"], t["P"], t["W"], t["deg"], t["rho"],
            t["omega"], t["lam"], nact, tau=1.0, lam0=lam0, h=0.35,
            kernel=kernel, want_kkt=kkt)
        for a, b, g in zip(ot, oj, got):
            _close(a.numpy(), np.asarray(b), ATOL)
            _close(g.numpy(), a.numpy(), ATOL)


def test_plain_versions_launch_nothing():
    """On CPU tensors the wrappers run the plain versions and never touch
    a launch counter."""
    ops.reset_launches()
    d = _t(_problem(2, 5, 4))
    ops.csvm_block_update(d["X"], d["y"], d["B"], d["P"], d["neigh"],
                          d["rho"], d["omega"], d["lam"], h=0.3)
    ops.csvm_local_update(d["X"], d["y"], d["B"], d["P"], d["neigh"],
                          d["rho"], d["omega"], d["lam"], h=0.3)
    ops.csvm_round_block(d["X"], d["y"], d["B"], d["P"], d["W"], d["deg"],
                         d["rho"], d["omega"], d["lam"],
                         torch.tensor(2, dtype=torch.int32), tau=1.0,
                         lam0=0.0, h=0.3, num_rounds=2, want_kkt=True)
    assert ops.launches == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("m,n,p,dtype,rounds", [
    (5, 13, 37, torch.float32, 1),
    (5, 13, 37, torch.bfloat16, 4),
    (16, 1024, 4096, torch.float32, 300),
    (16, 1024, 4096, torch.bfloat16, 4),
    (10, 200, 101, torch.float32, 7),
])
def test_round_block_bytes_match_the_wrapper_buffers(m, n, p, dtype, rounds):
    """The residency rule's byte count is exactly the operands the wrapper
    checks plus the outputs and scratch it allocates (on the meta device:
    shapes only, no memory)."""
    meta = torch.device("meta")
    f32 = dict(dtype=torch.float32, device=meta)
    operands = [torch.empty((m, n, p), dtype=dtype, device=meta),
                torch.empty((m, n), **f32), torch.empty((m, p), **f32),
                torch.empty((m, p), **f32), torch.empty((m, m), **f32),
                torch.empty((m,), **f32), torch.empty((m,), **f32),
                torch.empty((m,), **f32), torch.empty((p,), **f32),
                torch.empty((), dtype=torch.int32, device=meta)]
    buffers = ops._round_block_buffers(*operands, rounds)
    total = sum(t.numel() * t.element_size() for t in operands + list(buffers))
    assert total == ops.round_block_bytes(m, n, p, dtype.itemsize, rounds)
    assert buffers[3].numel() == ops.round_block_scratch_floats(m, n, p,
                                                                rounds)


def test_residency_rule_and_wrapper_checks():
    assert ops.megakernel_supported(64, 4096, 4096)          # CPU: any size
    assert ops.megakernel_supported(8, 100, 50, torch.bfloat16, device="cpu")
    with pytest.raises(ValueError):
        ops.megakernel_supported(8, 100, 50, device="meta")
    meta = torch.device("meta")
    good = [torch.empty((2, 3, 4), device=meta),
            torch.empty((2, 3), device=meta), torch.empty((2, 4), device=meta),
            torch.empty((2, 4), device=meta), torch.empty((2, 2), device=meta),
            torch.empty((2,), device=meta), torch.empty((2,), device=meta),
            torch.empty((2,), device=meta), torch.empty((4,), device=meta),
            torch.empty((), dtype=torch.int32, device=meta)]
    ops._round_block_buffers(*good, 1)
    bad_dtype = list(good)
    bad_dtype[1] = torch.empty((2, 3), dtype=torch.float64, device=meta)
    with pytest.raises(TypeError, match="y has dtype"):
        ops._round_block_buffers(*bad_dtype, 1)
    bad_shape = list(good)
    bad_shape[4] = torch.empty((2, 3), device=meta)
    with pytest.raises(ValueError, match="W has shape"):
        ops._round_block_buffers(*bad_shape, 1)
    bad_nact = list(good)
    bad_nact[-1] = torch.empty((), dtype=torch.int64, device=meta)
    with pytest.raises(TypeError, match="nact"):
        ops._round_block_buffers(*bad_nact, 1)
    strided = list(good)
    strided[2] = torch.empty((4, 2), device=meta).t()
    with pytest.raises(ValueError, match="contiguous"):
        ops._round_block_buffers(*strided, 1)
    with pytest.raises(ValueError, match="num_rounds"):
        ops._round_block_buffers(*good, 0)
    two = [good[0], good[1], good[2], good[3], good[2], good[5], good[6],
           good[8]]
    ops._check_two_pass("t", *two, ops._X_DTYPES)
    with pytest.raises(TypeError, match="X has dtype"):
        ops._check_two_pass("t", torch.empty((2, 3, 4), dtype=torch.float16,
                                             device=meta), *two[1:],
                            ops._X_DTYPES)
