"""Torch port on the card: each CUDA kernel against its plain torch version,
the port's fits through the kernels against the plain backend, and the
serving paths through the flash-attention and ssd_scan kernels.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the CUDA kernels have no CPU mode).  The file imports no jax, so
it also runs where only the port's dependencies are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch.core as tc
from repro_torch.core.graph import ring
from repro_torch.kernels import csvm_update as cu
from repro_torch.kernels import ops, ref

from _torch_cases import (ROUND_CASES, TWO_PASS_CASES, problem,
                          two_pass_problem)
from _torch_cases import one_thread  # noqa: F401

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


@pytest.mark.parametrize("instance,grid", [("stream", None), ("stream", 1),
                                           ("stream", 7), ("direct", None)])
@pytest.mark.parametrize("case", ROUND_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_block_instances_match_plain(cuda, case, dtype, instance,
                                           grid):
    """Each instance of the round kernel against the plain version: the
    stream instance at its own grid (node-crossing ranges in the last two
    cases), at one block and at 7 blocks (ranges crossing nodes in every
    case with m*n > 7); held rounds and nact = 0 leave B and P bit-equal."""
    m, n, p, R, nact, kkt, lam0, _, kernel = case
    t = _on(problem(m, n, p, seed=m + n + p), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["W"], t["deg"],
            t["rho"], t["omega"], t["lam"])
    kw = dict(tau=1.0, lam0=lam0, h=0.35, kernel=kernel, num_rounds=R,
              want_kkt=kkt)
    before = dict(ops.round_block_launches)
    got = ops._round_block_launch(
        *args, torch.tensor(nact, dtype=torch.int32, device=cuda), instance,
        grid=grid, **kw)
    ran = {k: v - before[k] for k, v in ops.round_block_launches.items()}
    assert ran == {k: int(k == instance) for k in ops.ROUND_INSTANCES}
    want = cu.csvm_round_block_plain(*args, nact, **kw)
    for g, w in zip(got, want):
        _close(g, w, ATOL if dtype == torch.float32 else ATOL_BF16_KERNEL)
    if nact == 0:
        assert torch.equal(got[0], t["B"]) and torch.equal(got[1], t["P"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_instance_is_deterministic(cuda, dtype):
    """Two launches of the stream instance give the same bits: B, P and
    the statistic (ragged p, ranges crossing nodes, the KKT pass)."""
    t = _on(problem(6, 50, 301, seed=9), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["W"], t["deg"],
            t["rho"], t["omega"], t["lam"],
            torch.tensor(7, dtype=torch.int32, device=cuda))
    kw = dict(tau=1.0, lam0=0.05, h=0.3, num_rounds=7, want_kkt=True)
    assert ops.round_block_instance(6, 50, 301, dtype) == "stream"
    a = ops.csvm_round_block(*args, **kw)
    b = ops._round_block_launch(*args, "stream", grid=5, **kw)
    c = ops._round_block_launch(*args, "stream", grid=5, **kw)
    for x, y in zip(b, c):
        assert torch.equal(x, y)
    for x, y in zip(a, ops.csvm_round_block(*args, **kw)):
        assert torch.equal(x, y)


def test_p_above_the_stream_limit_takes_the_direct_instance(cuda):
    """p = 8200 > 8192: the wrapper launches the direct instance, which
    matches the plain version; the stream instance refuses it."""
    m, n, p = 2, 5, ops.STREAM_MAX_P + 8
    t = _on(problem(m, n, p, seed=2), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["W"], t["deg"], t["rho"],
            t["omega"], t["lam"])
    kw = dict(tau=1.0, lam0=0.0, h=0.3, num_rounds=3, want_kkt=True)
    nact = torch.tensor(3, dtype=torch.int32, device=cuda)
    assert ops.round_block_instance(m, n, p) == "direct"
    assert ops.megakernel_supported(m, n, p, torch.float32, device=cuda)
    ops.reset_launches()
    got = ops.csvm_round_block(*args, nact, **kw)
    assert ops.round_block_launches == {"stream": 0, "direct": 1}
    for g, w in zip(got, cu.csvm_round_block_plain(*args, 3, **kw)):
        _close(g, w, ATOL)
    with pytest.raises(ValueError, match="p <= 8192"):
        ops._round_block_launch(*args, nact, "stream", **kw)
    assert ops.round_block_launches == {"stream": 0, "direct": 1}


def test_stream_instance_raises_on_a_misaligned_x(cuda):
    """X's base off a 16-byte boundary raises before any launch (the bulk
    copies need it), and is not rerouted to the direct instance."""
    t = _on(problem(3, 20, 9, seed=1), cuda)
    flat = torch.zeros(1 + t["X"].numel(), device=cuda)
    X = flat[1:].view(t["X"].shape)
    X.copy_(t["X"])
    before = dict(ops.launches), dict(ops.round_block_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.csvm_round_block(X, t["y"], t["B"], t["P"], t["W"], t["deg"],
                             t["rho"], t["omega"], t["lam"],
                             torch.tensor(2, dtype=torch.int32, device=cuda),
                             tau=1.0, lam0=0.0, h=0.3, num_rounds=2)
    assert (dict(ops.launches), dict(ops.round_block_launches)) == before


@pytest.mark.parametrize("backend", ["megakernel", "megakernel_bf16"])
def test_megakernel_fits_take_the_stream_instance(cuda, backend):
    """Every csvm_round_block launch of the two megakernel fits (one for
    decsvm_fit, one per check block for the KKT fit) is on the stream
    instance."""
    sim = tc.SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = tc.generate(sim, seed=1)
    W = ring(sim.m)
    cfg = tc.ADMMConfig(lam=0.05, max_iter=60, backend=backend)
    ops.reset_launches()
    tc.decsvm_fit(X, y, W, cfg)
    assert ops.round_block_launches == {"stream": 1, "direct": 0}
    ops.reset_launches()
    _, t = tc.decsvm_fit_tol(X, y, W, cfg, tol=-1.0, stop_rule="kkt",
                             check_every=7)
    assert ops.launches["csvm_round_block"] == -(-60 // 7)
    assert ops.round_block_launches == {
        "stream": ops.launches["csvm_round_block"], "direct": 0}


# the two-pass update's instances: the stream one at the wrapper's grid, at
# one block and at 7 (ranges crossing nodes in every case), and the direct
# one
TWO_PASS_RUNS = [("stream", None), ("stream", 1), ("stream", 7),
                 ("direct", None)]


def _two_pass_ran(before):
    return {k: v - before[k] for k, v in ops.two_pass_launches.items()}


@pytest.mark.parametrize("instance,grid", TWO_PASS_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TWO_PASS_CASES)
def test_block_update_instances_match_plain(cuda, case, dtype, instance,
                                            grid):
    """Each instance of csvm_block_update against the plain version: fp32
    within 1e-5, bf16 within the kernel tier with sign-exact support;
    ragged p, padded rows (y = 0), every smoothing kernel."""
    kernel = case[3]
    t = _on(two_pass_problem(case), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["neigh"], t["rho"],
            t["omega"], t["lam"])
    before = dict(ops.two_pass_launches)
    got = ops._two_pass_launch("csvm_block_update", *args, instance, h=0.3,
                               kernel=kernel, grid=grid)
    assert _two_pass_ran(before) == {k: int(k == instance)
                                     for k in ops.TWO_PASS_INSTANCES}
    want = cu.csvm_block_update_plain(*args, h=0.3, kernel=kernel)
    _close(got, want, ATOL if dtype == torch.float32 else ATOL_BF16_KERNEL)
    if dtype == torch.bfloat16:
        supp = want.abs() > ATOL_BF16
        assert torch.equal(torch.sign(got)[supp], torch.sign(want)[supp])


@pytest.mark.parametrize("instance,grid", TWO_PASS_RUNS)
@pytest.mark.parametrize("scalar_lam", [True, False])
@pytest.mark.parametrize("case", TWO_PASS_CASES)
def test_local_update_instances_match_plain(cuda, case, scalar_lam,
                                            instance, grid):
    """Each instance of csvm_local_update (fp32 X) against the plain
    version within 1e-5, lambda a scalar or a (p,) vector; the wrapper's
    one-node form too."""
    m, n, p, kernel = case[:4]
    t = _on(two_pass_problem(case), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"], t["omega"])
    lam = float(t["lam"][0]) if scalar_lam else t["lam"]
    lam_vec = torch.full((p,), lam, device=cuda) if scalar_lam else lam
    before = dict(ops.two_pass_launches)
    got = ops._two_pass_launch("csvm_local_update", *args, lam_vec,
                               instance, h=0.3, kernel=kernel, grid=grid)
    assert _two_pass_ran(before) == {k: int(k == instance)
                                     for k in ops.TWO_PASS_INSTANCES}
    want = cu.csvm_local_update_plain(*args, lam, h=0.3, kernel=kernel)
    _close(got, want, ATOL)
    one = ops.csvm_local_update(*(a[m - 1] for a in args), lam, h=0.3,
                                kernel=kernel)
    _close(one, want[m - 1], ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_stream_instance_is_deterministic(cuda, dtype):
    """Two launches of the two-pass stream instance give the same bits, at
    the wrapper's grid and at 5 blocks (ragged p, ranges crossing
    nodes)."""
    t = _on(problem(6, 50, 301, seed=9), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["neigh"], t["rho"],
            t["omega"], t["lam"])
    assert ops.two_pass_instance(6, 50, 301, dtype,
                                 args[0].data_ptr()) == "stream"
    ops.reset_launches()
    a = ops.csvm_block_update(*args, h=0.3)
    assert torch.equal(a, ops.csvm_block_update(*args, h=0.3))
    b = ops._two_pass_launch("csvm_block_update", *args, "stream", h=0.3,
                             grid=5)
    assert torch.equal(b, ops._two_pass_launch(
        "csvm_block_update", *args, "stream", h=0.3, grid=5))
    assert ops.two_pass_launches == {"stream": 4, "direct": 0}


def test_two_pass_misaligned_x_takes_the_direct_instance(cuda):
    """X's base off a 16-byte boundary — an offset view, and node 1 of a
    stack whose n*p is not a multiple of 4 through the one-node form —
    runs the direct instance (no raise) and matches the plain version."""
    m, n, p = 3, 13, 37
    assert (n * p) % 4
    t = _on(problem(m, n, p, seed=5), cuda)
    flat = torch.zeros(1 + t["X"].numel(), device=cuda)
    X = flat[1:].view(m, n, p)
    X.copy_(t["X"])
    assert X.data_ptr() % 16 and t["X"][1].data_ptr() % 16
    rest = (t["y"], t["B"], t["P"], t["neigh"], t["rho"], t["omega"],
            t["lam"])
    ops.reset_launches()
    got = ops.csvm_block_update(X, *rest, h=0.3)
    assert ops.two_pass_launches == {"stream": 0, "direct": 1}
    _close(got, cu.csvm_block_update_plain(t["X"], *rest, h=0.3), ATOL)
    one = ops.csvm_local_update(*(a[1] for a in (t["X"],) + rest[:-1]),
                                t["lam"], h=0.3)
    assert ops.two_pass_launches == {"stream": 0, "direct": 2}
    _close(one, cu.csvm_local_update_plain(t["X"], *rest, h=0.3)[1], ATOL)


def test_two_pass_p_above_the_stream_limit_takes_the_direct_instance(cuda):
    """p = 8200 > 8192: both wrappers launch the direct instance, which
    matches the plain version; the stream instance refuses it."""
    m, n, p = 2, 5, ops.STREAM_MAX_P + 8
    t = _on(problem(m, n, p, seed=2), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"], t["omega"],
            t["lam"])
    assert ops.two_pass_instance(m, n, p, x_ptr=t["X"].data_ptr()) == \
        "direct"
    ops.reset_launches()
    _close(ops.csvm_block_update(*args, h=0.3),
           cu.csvm_block_update_plain(*args, h=0.3), ATOL)
    _close(ops.csvm_local_update(*args, h=0.3),
           cu.csvm_local_update_plain(*args, h=0.3), ATOL)
    assert ops.two_pass_launches == {"stream": 0, "direct": 2}
    with pytest.raises(ValueError, match="p <= 8192"):
        ops._two_pass_launch("csvm_block_update", *args, "stream", h=0.3)
    assert ops.two_pass_launches == {"stream": 0, "direct": 2}


def test_pallas_and_track_history_fits_take_the_stream_instance(cuda):
    """Every two-pass launch of the pallas fit (csvm_local_update) and of
    the track_history fit (csvm_block_update) is on the stream instance,
    and both fits match the plain fit."""
    sim = tc.SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = tc.generate(sim, seed=1)
    W = ring(sim.m)
    cfg = lambda b: tc.ADMMConfig(lam=0.05, max_iter=60, backend=b)
    want = tc.decsvm_fit(X, y, W, cfg("jnp"))
    ops.reset_launches()
    got = tc.decsvm_fit(X, y, W, cfg("pallas"))
    assert ops.launches["csvm_local_update"] == 60
    assert ops.two_pass_launches == {"stream": 60, "direct": 0}
    _close(got, want, ATOL)
    ops.reset_launches()
    got, _ = tc.decsvm_fit(X, y, W, cfg("megakernel"), track_history=True)
    assert ops.launches["csvm_block_update"] == 60
    assert ops.two_pass_launches == {"stream": 60, "direct": 0}
    _close(got, want, ATOL)


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


def test_megakernel_fit_on_a_misaligned_view_of_x(cuda):
    """X as an offset view on the card (its base 4 bytes past a 16-byte
    boundary, n*p not a multiple of 4): the megakernel fit copies it to an
    aligned buffer, runs the stream instance once and matches the plain
    fit, where the kernel alone refuses such a base."""
    sim = tc.SimConfig(p=20, s=4, m=4, n=61)
    X, y, _ = tc.generate(sim, seed=1)
    m, n, p = X.shape
    assert (n * p) % 4
    big = torch.zeros(1 + X.size, device=cuda)
    Xv = big[1:].view(m, n, p)
    Xv.copy_(torch.from_numpy(np.asarray(X, np.float32)))
    assert Xv.data_ptr() % 16
    W = ring(sim.m)
    cfg = lambda b: tc.ADMMConfig(lam=0.05, max_iter=60, backend=b)
    ops.reset_launches()
    got = tc.decsvm_fit(Xv, y, W, cfg("megakernel"))
    assert ops.round_block_launches == {"stream": 1, "direct": 0}
    want = tc.decsvm_fit(Xv, y, W, cfg("jnp"))
    _close(got, want, ATOL)
    _close(got, tc.decsvm_fit(X, y, W, cfg("megakernel")), ATOL)


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


# --------------------------------------------------------------------------
# flash_attention and the serving path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype):
    """The shapes and limits of chip_smoke.py: fp32 within 2e-5, bf16
    within one bf16 ulp of the plain output; qwen3-14b's shapes go in as
    the model's strided views."""
    q, k, v = chip_smoke.attention_inputs(torch, case, dtype, cuda, seed=1)
    causal, window = case[5], case[6]
    before = ops.launches["flash_attention"]
    instance = ops.flash_instance(q.dtype, q.shape[-1])
    before_instance = ops.flash_launches[instance]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launches["flash_attention"] == before + 1
    assert ops.flash_launches[instance] == before_instance + 1
    want = ref.mha(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _, share = chip_smoke.flash_deviation(torch, got, want, dtype)
    assert share <= 1.0


def test_tensor_core_flash_raises_on_a_misaligned_base(cuda):
    """bf16 at D = 128 with a q base off a 16-byte boundary: a request for
    the tensor-core instance by name raises before any launch (the
    wrapper itself takes the fp32-FMA instance, below)."""
    flat = torch.zeros(1 + 4 * 64 * 128, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(1, 4, 64, 128)
    k = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16, device=cuda)
    before = dict(ops.launches), dict(ops.flash_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._flash_launch(q, k, k, "wgmma", causal=True, window=None,
                          sm_scale=None)
    assert (dict(ops.launches), dict(ops.flash_launches)) == before


@pytest.mark.parametrize("fault", ["base", "stride"])
def test_misaligned_bf16_attention_takes_the_fma_instance(cuda, fault):
    """A bf16 q whose base is 2 bytes off 16, or whose row pitch is 132
    elements, goes to the fp32-FMA instance: one launch there, within one
    bf16 ulp of the plain version, where the tensor-core instance could not
    take it."""
    q, k, v = chip_smoke.attention_inputs(torch, (1, 8, 2, 300, 128),
                                          "bfloat16", cuda, seed=5)
    if fault == "base":
        bad = torch.zeros(1 + q.numel(), dtype=q.dtype,
                          device=cuda)[1:].view(q.shape)
    else:
        bad = torch.zeros(*q.shape[:3], 132, dtype=q.dtype,
                          device=cuda)[..., :128]
    bad.copy_(q)
    ops.reset_launches()
    got = ops.flash_attention(bad, k, v, causal=True)
    assert ops.flash_launches == {"wgmma": 0, "fma": 1}
    want = ref.mha(bad, k, v, causal=True)
    _, share = chip_smoke.flash_deviation(torch, got, want, "bfloat16")
    assert share <= 1.0


def test_reduced_bf16_prefill_takes_the_tensor_core_instance(cuda):
    """A bf16 block prefill of the reduced qwen3-14b (D = 64, group 2):
    one tensor-core launch per layer, logits within chip_smoke's bf16
    in-model limit of the plain attention's."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced("qwen3_14b", param_dtype="bfloat16")
    params = model.init_params(cfg, seed=0, device=cuda)
    ops.reset_launches()
    dev, _ = chip_smoke.kernel_vs_plain_in_model(
        torch, ops, cfg, params, label="reduced bf16",
        tol=chip_smoke.MODEL_TOL["bfloat16"], prompt=333)
    assert ops.flash_launches == {"wgmma": cfg.num_layers, "fma": 0}
    assert dev <= chip_smoke.MODEL_TOL["bfloat16"]


def test_flash_attention_raises_without_its_library(cuda, monkeypatch,
                                                    tmp_path):
    """A CUDA tensor gets the kernel or an error — never the plain
    version."""
    from repro_torch.kernels import build
    q = torch.randn(1, 4, 64, 32, device=cuda)
    k = torch.randn(1, 2, 64, 32, device=cuda)
    monkeypatch.setitem(build.SOURCES, "flash_attention",
                        tmp_path / "missing.cu")
    monkeypatch.delitem(build._loaded, "flash_attention", raising=False)
    ops._flash_lib.cache_clear()
    before = dict(ops.launches)
    try:
        with pytest.raises((OSError, RuntimeError)):
            ops.flash_attention(q, k, k)
    finally:
        ops._flash_lib.cache_clear()
    assert ops.launches == before


def test_attention_and_prefill_launch_the_kernel(cuda, monkeypatch):
    """attention_forward launches the kernel once, a block prefill once
    per layer, and both agree with the plain attention on the card."""
    from repro_torch import configs
    from repro_torch.models import attention, model
    from repro_torch.models.prefill import prefill
    cfg = configs.get_reduced("qwen3_14b")
    params = model.init_params(cfg, seed=0, device=cuda)
    x = torch.randn(2, 75, cfg.d_model, device=cuda) * 0.5
    ops.reset_launches()
    got = attention.attention_forward(params.layers[0].attn, x, cfg)
    assert ops.launches["flash_attention"] == 1
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 75))
    logits, _, _ = prefill(params, {"tokens": toks}, cfg, 80)
    assert ops.launches["flash_attention"] == 1 + cfg.num_layers
    monkeypatch.setattr(attention, "self_attend",
                        chip_smoke.plain_self_attend)
    want = attention.attention_forward(params.layers[0].attn, x, cfg)
    plain_logits, _, _ = prefill(params, {"tokens": toks}, cfg, 80)
    assert ops.launches["flash_attention"] == 1 + cfg.num_layers
    _close(got, want, 2e-5)
    _close(logits, plain_logits, 1e-4)


def test_serve_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of the reduced fp32 qwen3-14b with block prefill, on
    the card (kernel) and on the CPU (plain attention)."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serving import Request, ServeEngine
    cfg = configs.get_reduced("qwen3_14b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (70, 9, 130)]
    out = {}
    for device in ("cpu", cuda):
        eng = ServeEngine(cfg, model.init_params(cfg, seed=0, device="cpu"),
                          max_batch=2, max_len=160, block_prefill=True,
                          device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        out[str(device)] = {r: q.generated for r, q in eng.run().items()}
    assert out["cpu"] == out[str(cuda)]


# --------------------------------------------------------------------------
# flash_attention with keys of their own length; the VLM and the
# encoder-decoder on the card
# --------------------------------------------------------------------------

CROSS_RUNS = [(case, "float32", "fma") for case in
              chip_smoke.CROSS_CASES + [chip_smoke.ENCODER_CASE]] + [
    (case, "bfloat16", instance) for case in
    chip_smoke.CROSS_CASES + [chip_smoke.ENCODER_CASE]
    for instance in ("wgmma", "fma")]


@pytest.mark.parametrize("case,dtype,instance", CROSS_RUNS)
def test_cross_flash_matches_plain(cuda, case, dtype, instance):
    """chip_smoke.py's cross cases and the encoder's shape, non-causal, as
    the model's strided views: each instance that takes the dtype, one
    launch of it, within the flash limits of ref.mha."""
    q, k, v = chip_smoke.cross_inputs(torch, case, dtype, cuda, seed=3)
    ops.reset_launches()
    got = ops._flash_launch(q, k, v, instance, causal=False, window=None,
                            sm_scale=None)
    assert ops.flash_launches[instance] == 1
    assert sum(ops.flash_launches.values()) == 1
    want = ref.mha(q, k, v, causal=False)
    assert got.dtype == q.dtype and got.shape == q.shape
    _, share = chip_smoke.flash_deviation(torch, got, want, dtype)
    assert share <= 1.0
    if instance == "wgmma":
        assert ops.flash_instance(q.dtype, q.shape[-1], q, k, v) == "wgmma"


CAUSAL_PATH_RUNS = [((B, H, KV, S, S, D), dtype, instance)
                    for _, (B, H, KV, S, D) in chip_smoke.CAUSAL_PATH_CASES
                    for dtype, instance in (("float32", "fma"),
                                            ("bfloat16", "wgmma"),
                                            ("bfloat16", "fma"))]


@pytest.mark.parametrize("case,dtype,instance", CAUSAL_PATH_RUNS)
def test_causal_flash_at_the_new_paths_shapes(cuda, case, dtype, instance):
    """chip_smoke.py's causal path cases (seamless's decoder, internvl2's
    prefills), as the model's strided views: each instance that takes the
    dtype, one launch of it, within the flash limits of ref.mha."""
    q, k, v = chip_smoke.cross_inputs(torch, case, dtype, cuda, seed=5)
    ops.reset_launches()
    got = ops._flash_launch(q, k, v, instance, causal=True, window=None,
                            sm_scale=None)
    assert ops.flash_launches[instance] == 1
    assert sum(ops.flash_launches.values()) == 1
    want = ref.mha(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _, share = chip_smoke.flash_deviation(torch, got, want, dtype)
    assert share <= 1.0
    if instance == "wgmma":
        assert ops.flash_instance(q.dtype, q.shape[-1], q, k, v) == "wgmma"


@pytest.mark.parametrize("instance", ["wgmma", "fma"])
def test_cross_flash_refuses_a_mask_before_any_launch(cuda, instance):
    """Sk != Sq with a causal mask or a window raises ValueError on the
    card before a launch, through the wrapper and by instance."""
    q, k, v = chip_smoke.cross_inputs(torch, (1, 4, 4, 33, 70, 64),
                                      "bfloat16", cuda, seed=4)
    ops.reset_launches()
    for kw in (dict(causal=True, window=None),
               dict(causal=False, window=16)):
        with pytest.raises(ValueError, match="keys of their own length"):
            ops.flash_attention(q, k, v, **kw)
        with pytest.raises(ValueError, match="keys of their own length"):
            ops._flash_launch(q, k, v, instance, sm_scale=None, **kw)
    assert sum(ops.launches.values()) == 0
    assert sum(ops.flash_launches.values()) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_encdec_on_the_card(cuda, dtype):
    """The reduced seamless-m4t: prefill logits with the kernel on the
    encoder, decoder and cross paths (one launch per layer and path)
    against the plain attention on the card, the bf16 in-model limit (fp32:
    the fp32 one); and the lockstep path's greedy tokens equal to the same
    run on the CPU in fp32."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced("seamless_m4t_large_v2", param_dtype=dtype)
    params = model.init_params(cfg, seed=0, device="cpu").to(cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 75))
    media = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    ops.reset_launches()
    dev, _ = chip_smoke.encdec_kernel_vs_plain(
        torch, ops, cfg, params, toks, media.to(cuda), label="reduced",
        tol=chip_smoke.MODEL_TOL[dtype])
    n = cfg.num_encoder_layers + 2 * cfg.num_layers
    want = {"wgmma": n, "fma": 0} if dtype == "bfloat16" else \
        {"wgmma": 0, "fma": n}
    assert ops.flash_launches == want
    if dtype == "float32":
        from repro_torch.models.prefill import prefill
        card = chip_smoke.encdec_generate(torch, ops, cfg, params, toks,
                                          media.to(cuda), new=6, max_len=96,
                                          instance="fma")
        cpu = model.init_params(cfg, seed=0, device="cpu")
        logits, cache, pos = prefill(cpu, {"tokens": toks,
                                           "enc_media": media}, cfg, 96)
        tok, out = torch.argmax(logits[:, -1], -1), []
        for t in range(6):
            out.append(tok)
            logits, cache = model.decode_step(cpu, cache, tok, pos + t, cfg)
            tok = torch.argmax(logits, -1)
        assert card["tokens"] == torch.stack(out, 1).tolist()


def test_reduced_vlm_on_the_card(cuda):
    """The reduced internvl2 in bf16: block prefill and the forward pass
    behind its media prefix with the tensor-core kernel against the plain
    attention (one launch a layer, the bf16 in-model limit); in fp32 the
    engine's tokens on the card equal the CPU's."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serving import Request, ServeEngine
    cfg = configs.get_reduced("internvl2_1b", param_dtype="bfloat16")
    params = model.init_params(cfg, seed=0, device=cuda)
    ops.reset_launches()
    dev, _ = chip_smoke.in_model_instances(torch, ops, cfg, params,
                                           label="reduced vlm bf16",
                                           instance="wgmma", prompt=150)
    out = chip_smoke.media_forward(torch, ops, cfg, params, text=40)
    assert out["instances"] == {"wgmma": cfg.num_layers, "fma": 0}
    cfg = configs.get_reduced("internvl2_1b")
    prompts = [np.random.default_rng(6).integers(0, cfg.vocab_size,
                                                 n).tolist()
               for n in (40, 9)]
    got = {}
    for device in ("cpu", cuda):
        eng = ServeEngine(cfg, model.init_params(cfg, seed=0, device="cpu"),
                          max_batch=2, max_len=64, block_prefill=True,
                          device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=5))
        got[str(device)] = {r: q.generated for r, q in eng.run().items()}
    assert got["cpu"] == got[str(cuda)]


# --------------------------------------------------------------------------
# ssd_scan and the mamba2 serving path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.SSD_CASES)
def test_ssd_scan_matches_plain(cuda, case, dtype):
    """The shapes and limits of chip_smoke.py: y fp32 within 5e-5, bf16
    within one bf16 ulp of the plain y; the fp32 final state within
    5e-5 (1 + |s_plain|); mamba2-370m's shapes go in as the model's strided
    slices of one conv output (1999: a ragged last chunk)."""
    args = chip_smoke.ssd_inputs(torch, case, dtype, cuda, seed=1)
    chunk = case[5]
    before = ops.launches["ssd_scan"]
    got = ops.ssd_scan(*args, chunk=chunk)
    assert ops.launches["ssd_scan"] == before + 1
    want = ref.ssd_scan(*args, chunk=chunk)
    assert got[0].dtype == args[0].dtype and got[0].shape == want[0].shape
    assert got[1].dtype == torch.float32 and got[1].shape == want[1].shape
    (_, y_share), (_, s_share) = chip_smoke.ssd_deviation(torch, got, want,
                                                          dtype)
    assert y_share <= 1.0 and s_share <= 1.0


WGMMA_SSD_CASES = [c for c in chip_smoke.SSD_CASES
                   if ops.ssd_instance(torch.bfloat16, *c[3:]) == "wgmma"]


@pytest.mark.parametrize("instance", ["wgmma", "fma"])
@pytest.mark.parametrize("case", WGMMA_SSD_CASES)
def test_ssd_instances_match_plain_on_the_tensor_core_cases(cuda, case,
                                                            instance):
    """Every bf16 case the tensor-core instance takes, on it (the wrapper's
    choice) and on the fp32-FMA instance, at chip_smoke.py's limits: y
    within one bf16 ulp of the plain y, the state within 5e-5 (1 + |s|);
    each call is one launch of its instance."""
    b, s, h, p, n, chunk = case
    args = chip_smoke.ssd_inputs(torch, case, "bfloat16", cuda, seed=2)
    ops.reset_launches()
    if instance == "wgmma":
        got = ops.ssd_scan(*args, chunk=chunk)
    else:
        got = ops._ssd_launch(*args, chunk, "fma")
    assert ops.ssd_launches == {k: int(k == instance)
                                for k in ops.SSD_INSTANCES}
    assert ops.launches["ssd_scan"] == 1
    want = ref.ssd_scan(*args, chunk=chunk)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == want[0].shape
    assert got[1].dtype == torch.float32 and got[1].shape == want[1].shape
    (_, y_share), (_, s_share) = chip_smoke.ssd_deviation(torch, got, want,
                                                          "bfloat16")
    assert y_share <= 1.0 and s_share <= 1.0


@pytest.mark.parametrize("case", [(1, 190, 4, 64, 256, 64),
                                  (1, 300, 2, 64, 192, 128)])
def test_ssd_tensor_core_instance_past_the_prefetched_rows(cuda, case):
    """n above the 128 rows of state_in the output pass prefetches (the
    rest are read directly; n = 192 pads to three 64-row panels, chunk
    128 runs two warpgroups), on inputs drawn as mamba2-370m forms them,
    at chip_smoke.py's limits."""
    b, s, h, p, n, chunk = case
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    f32 = dict(generator=gen, device=cuda, dtype=torch.float32)
    buf = torch.nn.functional.silu(0.5 * torch.randn(
        (b, s, h * p + 2 * n), **f32)).to(torch.bfloat16)
    x = buf[..., :h * p].reshape(b, s, h, p)
    B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), **f32))
    args = (x, dt, -torch.linspace(1.0, 16.0, h, device=cuda), B, C,
            torch.ones(h, device=cuda))
    assert ops.ssd_instance(torch.bfloat16, p, n, chunk) == "wgmma"
    got = ops.ssd_scan(*args, chunk=chunk)
    want = ref.ssd_scan(*args, chunk=chunk)
    (_, y_share), (_, s_share) = chip_smoke.ssd_deviation(torch, got, want,
                                                          "bfloat16")
    assert y_share <= 1.0 and s_share <= 1.0


def test_ssd_tensor_core_instance_is_deterministic(cuda):
    """Fixed sum orders, no atomics: two calls give the same bits of y
    and of the final state (mamba2-370m's shapes, a ragged last chunk)."""
    args = chip_smoke.ssd_inputs(torch, (1, 1999, 32, 64, 128, 64),
                                 "bfloat16", cuda, seed=3)
    y1, f1 = ops.ssd_scan(*args, chunk=64)
    y2, f2 = ops.ssd_scan(*args, chunk=64)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


def test_ssd_tensor_core_instance_raises_on_a_misaligned_base(cuda):
    """x, B or C off a 16-byte boundary, or with a stride that is not a
    multiple of 16 bytes: a request for the tensor-core instance by name
    raises before any launch; the wrapper runs the fp32-FMA instance, one
    launch, within the plain version's bf16 limits."""
    case = (1, 130, 2, 32, 64, 64)
    x, dt, A, B, C, D = chip_smoke.ssd_inputs(torch, case, "bfloat16", cuda,
                                              seed=4)
    flat = torch.zeros(1 + x.numel(), dtype=x.dtype, device=cuda)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    wide = torch.zeros(1, 130, 76, dtype=B.dtype, device=cuda)
    odd = wide[..., 8:72]             # an aligned base, a 152-byte stride
    odd.copy_(B)
    for bad in ((shifted, dt, A, B, C, D), (x, dt, A, odd, C, D)):
        before = dict(ops.launches), dict(ops.ssd_launches)
        with pytest.raises(ValueError, match="16"):
            ops._ssd_launch(*bad, 64, "wgmma")
        assert (dict(ops.launches), dict(ops.ssd_launches)) == before
        ops.reset_launches()
        got = ops.ssd_scan(*bad, chunk=64)
        assert ops.ssd_launches == {"wgmma": 0, "fma": 1}
        want = ref.ssd_scan(*bad, chunk=64)
        (_, y_share), (_, s_share) = chip_smoke.ssd_deviation(
            torch, got, want, "bfloat16")
        assert y_share <= 1.0 and s_share <= 1.0


def test_mamba2_prefill_runs_on_the_tensor_core_instance(cuda):
    """Full-width mamba2-370m in bf16: every one of the 48 ssd_scan
    launches of a block prefill is on the tensor-core instance."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.models.prefill import prefill
    cfg = configs.get("mamba2_370m")
    params = model.init_params(cfg, seed=0, device=cuda)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 333))
    ops.reset_launches()
    logits, _, _ = prefill(params, {"tokens": toks}, cfg, 334)
    assert bool(torch.isfinite(logits).all())
    assert ops.ssd_launches == {"wgmma": cfg.num_layers, "fma": 0}
    assert ops.launches["flash_attention"] == 0


def test_ssd_scan_raises_on_bad_operands_and_without_its_library(
        cuda, monkeypatch, tmp_path):
    """A CUDA tensor gets the kernel or an error — never the plain
    version: bad operands raise before launch, and so does a missing
    library."""
    from repro_torch.kernels import build
    args = chip_smoke.ssd_inputs(torch, (1, 70, 2, 8, 16, 16), "float32",
                                 cuda, seed=2)
    before = dict(ops.launches)
    for bad, err in (
            (dict(chunk=12), ValueError),
            (dict(chunk=256), ValueError),
            (dict(args=(args[0].double(), *args[1:])), TypeError),
            (dict(args=(args[0], args[1].cpu(), *args[2:])), ValueError),
            (dict(args=(args[0].transpose(2, 3), *args[1:])), ValueError)):
        with pytest.raises(err):
            ops.ssd_scan(*bad.get("args", args), chunk=bad.get("chunk", 16))
    monkeypatch.setitem(build.SOURCES, "ssd_scan", tmp_path / "missing.cu")
    monkeypatch.delitem(build._loaded, "ssd_scan", raising=False)
    ops._ssd_lib.cache_clear()
    try:
        with pytest.raises((OSError, RuntimeError)):
            ops.ssd_scan(*args, chunk=16)
    finally:
        ops._ssd_lib.cache_clear()
    assert ops.launches == before


def test_mamba2_prefill_launches_the_kernel_once_per_layer(cuda,
                                                           monkeypatch):
    """Full-width mamba2-370m (48 layers, bf16): a block prefill launches
    ssd_scan 48 times and no flash_attention; its logits and seeded SSM
    state agree with the plain scan swapped in (chip_smoke.py's bf16
    model limit)."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get("mamba2_370m")
    params = model.init_params(cfg, seed=0, device=cuda)
    ops.reset_launches()
    dev, _, sdev = chip_smoke.ssd_vs_plain_in_model(
        torch, ops, cfg, params, label="mamba2-370m bf16", prompt=300,
        tol=chip_smoke.MAMBA_TOL["bfloat16"])
    assert ops.launches["ssd_scan"] == cfg.num_layers
    assert ops.launches["flash_attention"] == 0


def test_mamba2_serve_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of the reduced fp32 mamba2-370m with block prefill, on
    the card (kernel at chunk 16, ragged tails) and on the CPU (plain
    ssd_chunked at JAX's chunk), across a reused slot."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serving import Request, ServeEngine
    cfg = configs.get_reduced("mamba2_370m")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (70, 9, 131)]
    out = {}
    for device in ("cpu", cuda):
        eng = ServeEngine(cfg, model.init_params(cfg, seed=0, device="cpu"),
                          max_batch=2, max_len=160, block_prefill=True,
                          device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        out[str(device)] = {r: q.generated for r, q in eng.run().items()}
    assert out["cpu"] == out[str(cuda)]


# --------------------------------------------------------------------------
# the lambda path
# --------------------------------------------------------------------------

def _path_problem():
    sim = tc.SimConfig(p=40, s=5, m=6, n=150, rho=0.5)
    X, y, _ = tc.generate(sim, seed=11)
    W = tc.graph.erdos_renyi(sim.m, 0.6, seed=2)
    return X, y, W, tc.tuning.lambda_grid(X, y, num=6)


@pytest.mark.parametrize("backend", ["megakernel", "megakernel_bf16"])
def test_lambda_path_launches_and_instances(cuda, backend):
    """The batched path is one stream-instance round launch per grid point,
    the warm path one fused 4-round + KKT launch per check block, LLA
    stage 2 one launch with a per-coordinate lam_vec; each matches the
    plain path on the card (fp32 1e-5; bf16 1e-2)."""
    X, y, W, lams = _path_problem()
    tol = ATOL_BF16 if backend == "megakernel_bf16" else ATOL
    cfg = lambda b: tc.ADMMConfig(lam=0.0, max_iter=120, backend=b)
    ops.reset_launches()
    got = tc.path.decsvm_path_batched(X, y, W, lams, cfg(backend))
    assert ops.round_block_launches == {"stream": len(lams), "direct": 0}
    want = tc.path.decsvm_path_batched(X, y, W, lams, cfg("jnp"))
    _close(got, want, tol)
    ops.reset_launches()
    path, iters = tc.path.decsvm_path_warm(X, y, W, lams, cfg(backend),
                                           tol=1e-3)
    blocks = sum(-(-int(t) // 4) for t in iters)
    assert ops.round_block_launches == {"stream": blocks, "direct": 0}
    wpath, witers = tc.path.decsvm_path_warm(X, y, W, lams, cfg("jnp"),
                                             tol=1e-3)
    if backend == "megakernel":
        assert torch.equal(iters, witers)
        _close(path, wpath, ATOL)
    ops.reset_launches()
    B, w = tc.penalties.decsvm_fit_lla(X, y, W, cfg(backend), lams=lams,
                                       path_mode="batched")
    assert ops.round_block_launches == {"stream": len(lams) + 1,
                                        "direct": 0}
    assert bool((w < 1).any()) and w.is_cuda
    B_ref, _ = tc.penalties.decsvm_fit_lla(X, y, W, cfg("jnp"), lams=lams,
                                           path_mode="batched")
    _close(B, B_ref, tol)


def test_cv_path_runs_no_kernel(cuda):
    """The masked fold fits take the reference rounds on the card."""
    X, y, W, lams = _path_problem()
    cfg = tc.ADMMConfig(lam=0.0, max_iter=40, backend="megakernel")
    ops.reset_launches()
    res = tc.path.decsvm_path_select(X, y, W, lams, cfg, mode="batched",
                                     criterion="cv", cv_folds=3)
    assert ops.launches["csvm_round_block"] == len(lams)   # the full path
    assert res.criteria.is_cuda and bool(torch.isfinite(res.criteria).all())


def test_chunked_path_launches_are_two_pass_on_stream(cuda):
    """The chunked engine carries no round kernel: each round of each grid
    point is one ``csvm_block_update`` launch on the stream instance, and
    the path matches the plain one on the card and the dense path."""
    X, y, W, lams = _path_problem()
    cfg = lambda b: tc.ADMMConfig(lam=0.0, max_iter=60, backend=b)
    ops.reset_launches()
    got = tc.decentral.decsvm_path_chunked(X, y, W, lams, cfg("megakernel"))
    assert ops.launches["csvm_round_block"] == 0
    assert ops.launches["csvm_block_update"] == 60 * len(lams)
    assert ops.two_pass_launches == {"stream": 60 * len(lams), "direct": 0}
    assert got.is_cuda
    want = tc.decentral.decsvm_path_chunked(X, y, W, lams, cfg("jnp"))
    _close(got, want, ATOL)
    dense = tc.path.decsvm_path_batched(X, y, W, lams, cfg("megakernel"))
    _close(got, dense, ATOL)


def test_sanitized_megakernel_fit_has_no_round_launch_and_raises(cuda):
    """Under ``sanitize=True`` a megakernel fit is one two-pass launch a
    round (no round kernel), equal to the one-launch fit; a NaN label
    raises E1 at round 0 on the card."""
    X, y, W, _ = _path_problem()
    cfg = tc.ADMMConfig(lam=0.05, max_iter=40, backend="megakernel")
    ops.reset_launches()
    B = tc.decsvm_fit(X, y, W, cfg)
    assert ops.round_block_launches == {"stream": 1, "direct": 0}
    ops.reset_launches()
    on = tc.ADMMConfig(lam=0.05, max_iter=40, backend="megakernel",
                       sanitize=True)
    Bs = tc.decsvm_fit(X, y, W, on)
    assert ops.launches["csvm_round_block"] == 0
    assert ops.two_pass_launches == {"stream": 40, "direct": 0}
    _close(Bs, B, ATOL)
    y_bad = y.copy()
    y_bad[1, 3] = np.nan
    with pytest.raises(tc.sanitize.SanitizerError,
                       match=r"E1:.*margin weight.*round 0"):
        tc.decsvm_fit(X, y_bad, W, on)


def test_dense_bucket_round_launches_equal_bucket_times_grid(cuda):
    """A dense fit-serving bucket of B problems on an L-point grid is B x L
    round launches on the stream instance, each result within 1e-5 of the
    same bucket under the plain backend."""
    from repro_torch.serving import DecsvmFitServer, FitRequest
    X, y, W, lams = _path_problem()
    probs = [(X, y, W)] + [
        (tc.generate(tc.SimConfig(p=40, s=5, m=6, n=150, rho=0.5),
                     seed=s)[:2] + (tc.graph.erdos_renyi(6, 0.6, seed=s),))
        for s in (12, 13)]

    def run(backend):
        srv = DecsvmFitServer()
        for i, (Xb, yb, Wb) in enumerate(probs):
            srv.submit(FitRequest(
                rid=i, X=Xb, y=yb, W=Wb, lams=lams, mode="batched",
                engine="dense",
                cfg=tc.ADMMConfig(lam=0.0, max_iter=60, backend=backend)))
        return srv.run(), srv

    ops.reset_launches()
    got, srv = run("megakernel")
    assert [(k[-1], n) for k, n in srv.bucket_log] == [("dense", 3)]
    assert ops.round_block_launches == {"stream": 3 * len(lams),
                                        "direct": 0}
    want, _ = run("jnp")
    for i in range(3):
        assert got[i].best_lam == want[i].best_lam
        np.testing.assert_allclose(got[i].B, want[i].B, atol=ATOL)


def test_two_ranks_on_the_card_match_one_rank(cuda):
    """Two ranks of one group on the card (gloo when they share it, NCCL
    with a card each): the sharded megakernel fit, one ``csvm_block_update``
    launch a round on each rank's block of nodes, all on the stream
    instance, equals the fit at one rank."""
    from _torch_ranks import fit_on_card
    from repro_torch.kernels import build
    from repro_torch.launch import ranks
    build.build_all()
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8, 64, 1024)).astype(np.float32)
    y = np.sign(rng.standard_normal((8, 64))).astype(np.float32)
    W = np.asarray(ring(8), np.float32)
    got = ranks.spawn(fit_on_card, 2, (X, y, W, 50), deadline_s=300.0)
    cfg = tc.ADMMConfig(lam=0.05, max_iter=50, backend="megakernel")
    one = tc.decentral.decsvm_fit_sharded(
        X, y, W, cfg, mesh=tc.decentral.make_node_mesh(1), device=cuda)
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    for out in got:
        assert out["backend"] == backend
        assert out["launches"] == 50
        assert out["instances"] == {"stream": 50, "direct": 0}
        torch.testing.assert_close(out["B"], one.cpu(), atol=ATOL, rtol=0)


def test_fit_serving_across_two_ranks_on_the_card(cuda):
    """Fit serving across two ranks of one group on the card (gloo when
    they share card 0, NCCL with a card each): rank 0 serves the chunked
    request of ``ranks.fit_requests`` (X (16, 64, 64) on 2 grid points,
    ``megakernel``), the other follows; the result within 1e-5 of the
    one-rank server's on the card (the same best lambda, table lambdas
    and stops), the follower's bit for bit, every two-pass launch on the
    stream instance on both ranks."""
    from _torch_ranks import fit_serving_on_card
    from repro_torch.kernels import build
    from repro_torch.launch import ranks
    build.build_all(("csvm_update",))
    s = ranks.fit_serving_setup(2, num=2, small=True)
    got = ranks.spawn(fit_serving_on_card, 2, (s,), deadline_s=300.0)
    one = ranks.serve_requests(ranks.fit_requests(s, "megakernel")[0][:1],
                               (), "cuda")
    for out in got:
        assert [b["engine"] for b in out["buckets"]] == ["chunked"]
        launches = out["buckets"][0]["launches"]["csvm_block_update"]
        assert launches > 0
        assert out["buckets"][0]["two_pass_instances"] == {"stream": launches}
        assert ranks._identical(out["results"][0], got[0]["results"][0])
    g, w = got[0]["results"][0], one["results"][0]
    dev, _ = ranks._same_fit("rid 0", g, w, (got[0]["paths"][0],
                                             one["paths"][0]),
                             16 * 64, 64, ATOL, pytest.fail)
    assert dev <= ATOL


def test_fit_serving_terms_across_two_ranks_on_the_card(cuda):
    """``ranks.run_fit_serving(2, num=2, small=True)``'s requests on the
    card (two ranks on card 0 under gloo, or a card each under NCCL), each
    term that ``ranks._same_fit`` holds (``ranks.fit_terms``: B, beta, the
    criterion less its support term, the LLA weights) printed for every
    request, rank 0's result against the one-rank server's, the one-rank
    server's against plain and rank 0's against plain (the readings of
    ROADMAP's Queue 3 item 6); rank 0's within 1e-5 of the one-rank
    server's on every term, the gate of ``check_fit_serving``."""
    from repro_torch.kernels import build
    from repro_torch.launch import ranks
    build.build_all(("csvm_update",))
    s = ranks.fit_serving_setup(2, num=2, small=True)
    got = ranks.spawn(ranks.rank_fit_serving, 2, (s,), deadline_s=600.0)
    one = ranks.serve_requests(*ranks.fit_requests(s, "megakernel"), "cuda")
    plain = ranks.serve_requests(*ranks.fit_requests(s, "jnp"), "cuda")
    r0 = got[0]["results"]
    for rid, (N, p) in ranks.request_sizes(s, 2).items():
        pairs = {"two ranks vs one rank": (r0[rid], one["results"][rid]),
                 "one rank vs plain": (one["results"][rid],
                                       plain["results"][rid]),
                 "two ranks vs plain": (r0[rid], plain["results"][rid])}
        terms = {name: ranks.fit_terms(g, w, N, p)
                 for name, (g, w) in pairs.items()}
        for name, t in terms.items():
            print(f"fitserve-terms rid {rid} {name}: "
                  + ", ".join(f"{k} {v:.4e}" for k, v in t.items()),
                  flush=True)
        assert max(terms["two ranks vs one rank"].values()) <= ATOL


def test_moe_routes_on_the_card(cuda):
    """Reduced granite-moe in bf16 on the card: the scatter route at a
    capacity that drops nothing within chip_smoke's relative limit of the
    dense route, and at the configured capacity bit for bit in two runs
    (no atomic adds)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import model, moe
    cfg = configs.get_reduced("granite_moe_1b_a400m", param_dtype="bfloat16")
    params = model.init_params(cfg, seed=0, device=cuda)
    layer = params.layers[0].moe
    h = torch.randn((2, 300, cfg.d_model), device=cuda).to(torch.bfloat16)
    ample = dataclasses.replace(cfg, moe_routing="scatter",
                                moe_capacity_factor=2.0)
    dense, _ = moe.moe_forward_dense(layer, h, cfg)
    scat, _ = moe.moe_forward_scatter(layer, h, ample)
    dev = float((scat.float() - dense.float()).abs().max())
    assert dev <= chip_smoke.MOE_LAYER_TOL * float(dense.float().abs().max())
    tight = dataclasses.replace(cfg, moe_routing="scatter")
    a, _ = moe.moe_forward_scatter(layer, h, tight)
    b, _ = moe.moe_forward_scatter(layer, h, tight)
    assert torch.equal(a, b)


def test_scatter_route_backward_repeats_bit_for_bit(cuda):
    """Reduced granite-moe in bf16 on the card under grad: the scatter
    route at the configured capacity (assignments drop) differentiated
    twice from the same weights and input gives the same gradients of x
    and of every MoE weight bit for bit (the dispatch's gather and its
    index-sum backward, the combine's sum over k: no atomic add); at a
    capacity that drops nothing its gradient of x is within chip_smoke's
    relative limit of the dense route's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import model, moe
    cfg = configs.get_reduced("granite_moe_1b_a400m", param_dtype="bfloat16")
    layer = model.init_params(cfg, seed=0, device=cuda,
                              trainable=True).layers[0].moe
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    # tokens that share one direction: the router sends most of them to
    # the same experts, past the capacity
    base = torch.randn((1, 1, cfg.d_model), generator=gen, device=cuda)
    h = (base + 0.1 * torch.randn((4, 512, cfg.d_model), generator=gen,
                                  device=cuda)).to(torch.bfloat16)
    w = torch.randn(h.shape, generator=gen, device=cuda).to(torch.bfloat16)

    def grads(c, forward):
        layer.zero_grad(set_to_none=True)
        x = h.clone().requires_grad_(True)
        y, aux = forward(layer, x, c)
        ((y.float() * w.float()).sum() + aux).backward()
        return [x.grad] + [p.grad for p in layer.parameters()]
    tight = dataclasses.replace(cfg, moe_routing="scatter")
    _, idx, _ = moe._route(layer, h.reshape(-1, cfg.d_model), cfg)
    assert int(torch.bincount(idx.reshape(-1)).max()) > moe.capacity(
        tight, idx.shape[0])
    first = grads(tight, moe.moe_forward_scatter)
    second = grads(tight, moe.moe_forward_scatter)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    ample = dataclasses.replace(tight, moe_capacity_factor=2.0)
    dense = grads(cfg, moe.moe_forward_dense)[0].float()
    scat = grads(ample, moe.moe_forward_scatter)[0].float()
    assert float((scat - dense).abs().max()) <= \
        chip_smoke.MOE_LAYER_TOL * float(dense.abs().max())


def test_hybrid_prefill_at_head_dim_256_takes_the_fma_instance(cuda):
    """The reduced recurrentgemma at its full head dim (D = 256) and 5
    layers in bf16: block prefill of a prompt longer than the window, one
    flash launch per attention layer, on the tensor-core instance (bf16 at
    D = 256 takes it), logits within chip_smoke's bf16 in-model limit of
    the plain attention's."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced("recurrentgemma_2b", num_layers=5,
                              head_dim=256, param_dtype="bfloat16")
    params = model.init_params(cfg, seed=0, device=cuda)
    ops.reset_launches()
    dev, _ = chip_smoke.kernel_vs_plain_in_model(
        torch, ops, cfg, params, label="reduced hybrid bf16 D=256",
        tol=chip_smoke.MODEL_TOL["bfloat16"], prompt=150)
    assert ops.flash_launches == {"wgmma": 2, "fma": 0}
    assert dev <= chip_smoke.MODEL_TOL["bfloat16"]


def test_head_features_and_fit_on_the_card_match_the_cpu(cuda):
    """The head's features (reduced qwen3-14b, fp32) on the card within
    the fp32 in-model limit of the CPU's, and the fit under ``megakernel``
    on the card within 1e-5 of the plain fit on the CPU, given the same
    features and rho."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.optim import decsvm_head as head
    cfg = configs.get_reduced("qwen3_14b")
    cpu = model.init_params(cfg, seed=0, device="cpu")
    card = model.init_params(cfg, seed=0, device="cpu").to(cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (96, 16))
    want = head.extract_features(cpu, cfg, toks)
    got = head.extract_features(card, cfg, toks)
    assert float((got.cpu() - want).abs().max()) <= \
        chip_smoke.MODEL_TOL["float32"]
    feats = want.reshape(4, 24, -1)
    y = np.sign(np.random.default_rng(1).standard_normal((4, 24)))
    rho = tc.compute_rho(head.standardize(feats, "cpu")[0], 0.3,
                         "epanechnikov")
    acfg = tc.ADMMConfig(lam=0.02, h=0.3, max_iter=200)
    B0, _ = head.train_decsvm_head(feats, y, ring(4), acfg, rho=rho,
                                   device="cpu")
    ops.reset_launches()
    B1, _ = head.train_decsvm_head(
        feats.to(cuda), y, ring(4),
        tc.ADMMConfig(lam=0.02, h=0.3, max_iter=200, backend="megakernel"),
        rho=rho)
    assert ops.launches["csvm_round_block"] == 1
    assert float((B1.cpu() - B0).abs().max()) <= ATOL


# (B, H, KV, S, Sk, D, causal, window): small shapes of every case the
# training paths give flash_attention_backward
BACKWARD_SMALL = [
    (1, 4, 2, 128, 128, 64, True, None), (2, 6, 2, 200, 200, 32, True, None),
    (1, 4, 2, 160, 160, 32, True, 17), (2, 4, 4, 100, 130, 64, False, None),
    (1, 8, 2, 150, 150, 128, True, None), (1, 2, 1, 170, 170, 256, True, 33),
    (1, 4, 2, 77, 77, 40, False, 9), (1, 14, 2, 99, 99, 64, True, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BACKWARD_SMALL)
def test_flash_backward_matches_plain(cuda, case, dtype):
    """The backward kernel against ``ref.mha_backward`` on the model's
    transposed buffers, within chip_smoke's limits (fp32 2e-5 of max
    |grad|; bf16 one ulp plus that floor), each result laid out as its
    input; two launches equal bit for bit."""
    causal, window = case[6], case[7]
    q, k, v, o, do = chip_smoke.backward_inputs(torch, ops, case, dtype,
                                                cuda, seed=3)
    before = dict(ops.launches)
    got = ops.flash_attention_backward(q, k, v, o, do, causal=causal,
                                       window=window)
    again = ops.flash_attention_backward(q, k, v, o, do, causal=causal,
                                         window=window)
    assert ops.launches["flash_attention_backward"] == \
        before["flash_attention_backward"] + 2
    want = ref.mha_backward(q, k, v, o, do, causal=causal, window=window)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert torch.equal(g, a)
        assert g.dtype == t.dtype and g.stride() == t.stride()
        _, _, share = chip_smoke.backward_deviation(torch, g, w, dtype)
        assert share <= 1.0


# (B, H, KV, Sq, Sk, D, causal, window): queries four times as many as
# the keys, non-causal, as seamless's training cross-attention (4096
# queries over 1024 frames), at small sizes
CROSS_BACKWARD = [(2, 4, 4, 256, 64, 64, False, None),
                  (1, 16, 16, 520, 130, 64, False, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CROSS_BACKWARD)
def test_cross_flash_backward_with_longer_queries_matches_plain(cuda, case,
                                                                 dtype):
    """The backward kernel with Sq != Sk (non-causal, Sq = 4 Sk) against
    ``ref.mha_backward`` within chip_smoke's limits, each gradient laid
    out as its input; two launches equal bit for bit."""
    q, k, v, o, do = chip_smoke.backward_inputs(torch, ops, case, dtype,
                                                cuda, seed=5)
    got = ops.flash_attention_backward(q, k, v, o, do, causal=False)
    again = ops.flash_attention_backward(q, k, v, o, do, causal=False)
    want = ref.mha_backward(q, k, v, o, do, causal=False)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert torch.equal(g, a)
        assert g.shape == t.shape and g.stride() == t.stride()
        _, _, share = chip_smoke.backward_deviation(torch, g, w, dtype)
        assert share <= 1.0


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_function_takes_delta_from_the_unrounded_output(cuda, D):
    """``ops.FlashAttention`` under grad on bf16 keys that are alike (a
    common row plus a small spread): the forward's unrounded output within
    chip_smoke's fp32 limit of the plain fp32 one, rounding to its output;
    dk and dv within the bf16 limit of ``ref.mha_backward`` given the same
    delta, rowsum(do * o32); a wk-like contraction x^T dk within 3x the
    floor of rounding the exact dk, where delta from the bf16 o is far off
    (tests/test_torch_flash_grad.py holds the plain closed forms).  dq is
    not held to the per-entry rule here: over keys this alike it is itself
    a zero sum, which the tensor-core instance's two-term dS moves past the
    rule (chip_smoke's phases 24-26 hold dq on random inputs at the
    training shapes)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    B, H, KV, S = 1, 4, 2, 512

    def alike(heads, spread):
        common = torch.randn((1, 1, 1, D), generator=gen, device=cuda)
        return common + spread * torch.randn((B, S, heads, D), generator=gen,
                                             device=cuda).transpose(1, 2)
    x = alike(KV, 0.02)
    q, k, v = (t.to(torch.bfloat16) for t in (alike(H, 0.05), x,
                                              alike(KV, 0.05)))
    do = torch.randn((B, H, S, D), generator=gen,
                     device=cuda).to(torch.bfloat16)
    ts = [t.float().requires_grad_() for t in (q, k, v)]
    full = ref.mha(*ts, causal=True)
    full.backward(do.float())
    exact = torch.einsum("bhsd,bhse->de", x, ts[1].grad)
    full = full.detach()
    ws = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = dict(ops.flash_backward_launches)
    out = ops.FlashAttention.apply(*ws, True, None, None)
    out.backward(do)
    assert ops.flash_backward_launches["wgmma"] == before["wgmma"] + 1
    o32 = torch.empty(q.shape, dtype=torch.float32, device=cuda)
    again = ops.flash_attention(q, k, v, causal=True, o32=o32)
    assert torch.equal(again, out.detach())
    assert torch.equal(o32.to(torch.bfloat16), again)
    assert float((o32 - full).abs().max()) <= chip_smoke.FLASH_TOL_F32
    delta = torch.sum(do.float() * o32, dim=-1)
    want = ref.mha_backward(q, k, v, out.detach(), do, causal=True,
                            delta=delta)
    for g, w in zip((t.grad for t in ws[1:]), want[1:]):
        _, _, share = chip_smoke.backward_deviation(torch, g, w, "bfloat16")
        assert share <= 1.0

    def contraction_error(dk):
        got = torch.einsum("bhsd,bhse->de", x, dk.float())
        return float((got - exact).abs().max() / exact.abs().max())
    floor = contraction_error(ts[1].grad.to(torch.bfloat16))
    assert contraction_error(ws[1].grad) <= 3 * floor
    rounded = ops.flash_attention_backward(q, k, v, out.detach(), do,
                                           causal=True)[1]
    assert contraction_error(rounded) > 10 * floor


# the cases of BACKWARD_SMALL that the tensor-core instance takes (bf16, D
# = 64, 128 or 256)
BACKWARD_TC = [c for c in BACKWARD_SMALL if c[5] in (64, 128, 256)]


@pytest.mark.parametrize("instance", ["wgmma", "fma"])
@pytest.mark.parametrize("case", BACKWARD_TC)
def test_flash_backward_instances_match_plain(cuda, case, instance):
    """Each instance of the backward kernel, forced by name, against
    ``ref.mha_backward`` on the same bf16 inputs within chip_smoke's limit
    (one bf16 ulp plus 2e-5 of max |grad|); two launches equal bit for
    bit; each launch counted on its instance."""
    causal, window = case[6], case[7]
    q, k, v, o, do = chip_smoke.backward_inputs(torch, ops, case, "bfloat16",
                                                cuda, seed=4)
    assert ops.flash_backward_instance(q.dtype, q.shape[-1], q, k, v, o,
                                       do) == "wgmma"
    before = dict(ops.flash_backward_launches)
    kw = dict(causal=causal, window=window, sm_scale=None)
    got = ops._flash_backward_launch(q, k, v, o, do, instance, **kw)
    again = ops._flash_backward_launch(q, k, v, o, do, instance, **kw)
    assert ops.flash_backward_launches[instance] == before[instance] + 2
    want = ref.mha_backward(q, k, v, o, do, causal=causal, window=window)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert torch.equal(g, a)
        assert g.dtype == t.dtype and g.stride() == t.stride()
        _, _, share = chip_smoke.backward_deviation(torch, g, w, "bfloat16")
        assert share <= 1.0


@pytest.mark.parametrize("what", ["q", "k", "v", "o", "do"])
@pytest.mark.parametrize("fault", ["base", "stride"])
def test_misaligned_bf16_backward_takes_the_fma_instance(cuda, what, fault):
    """A bf16 operand 2 bytes off a 16-byte boundary, or with a row pitch
    of 132 elements (not a multiple of 16 bytes), sends the call
    to the fp32-FMA instance, within the limit; the tensor-core instance,
    forced, refuses it before any launch."""
    case = (1, 4, 2, 96, 96, 128, True, None)
    ins = dict(zip(("q", "k", "v", "o", "do"), chip_smoke.backward_inputs(
        torch, ops, case, "bfloat16", cuda, seed=5)))
    t = ins[what]
    if fault == "base":
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        moved = flat[1:].view(t.shape)
    else:
        moved = torch.empty(*t.shape[:3], 132, dtype=t.dtype,
                            device=cuda)[..., :128]
    moved.copy_(t)
    ins[what] = moved
    args = tuple(ins.values())
    assert ops.flash_backward_instance(moved.dtype, 128, *args) == "fma"
    before = dict(ops.flash_backward_launches)
    got = ops.flash_attention_backward(*args, causal=True)
    assert ops.flash_backward_launches["fma"] == before["fma"] + 1
    want = ref.mha_backward(*args, causal=True)
    for g, w in zip(got, want):
        assert chip_smoke.backward_deviation(torch, g, w, "bfloat16")[2] <= 1
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="16"):
        ops._flash_backward_launch(*args, "wgmma", causal=True, window=None,
                                   sm_scale=None)
    assert ops.launches == before


# (B, H, KV, S, Sk, D, causal, window) at D = 256: recurrentgemma-2b's
# long prompt (the window active) and training shape, a short prompt, and
# keys of their own length (a ragged Sk, non-causal)
HEAD_DIM_256 = [
    (1, 10, 1, 2099, 2099, 256, True, 2048),
    (2, 10, 1, 4096, 4096, 256, True, 2048),
    (1, 10, 1, 77, 77, 256, True, None),
    (1, 10, 1, 300, 517, 256, False, None),
]


@pytest.mark.parametrize("instance", ["wgmma", "fma"])
@pytest.mark.parametrize("case", HEAD_DIM_256)
def test_head_dim_256_forward_instances_match_plain(cuda, case, instance):
    """Each instance of the forward at D = 256, forced by name, on the
    model's transposed bf16 buffers: within one bf16 ulp (plus 1e-6) of
    ``ref.mha``, two launches equal bit for bit and counted on their
    instance; the wrapper's own choice there is the tensor-core one."""
    B, H, KV, S, Sk, D, causal, window = case
    q, k, v, _, _ = chip_smoke.backward_inputs(torch, ops, case, "bfloat16",
                                               cuda, seed=6)
    assert ops.flash_instance(q.dtype, D, q, k, v) == "wgmma"
    kw = dict(causal=causal, window=window, sm_scale=None)
    before = dict(ops.flash_launches)
    got = ops._flash_launch(q, k, v, instance, **kw)
    again = ops._flash_launch(q, k, v, instance, **kw)
    assert ops.flash_launches[instance] == before[instance] + 2
    assert torch.equal(got, again)
    want = ref.mha(q, k, v, causal=causal, window=window)
    assert got.stride() == q.stride()
    assert chip_smoke.flash_deviation(torch, got, want, "bfloat16")[1] <= 1


@pytest.mark.parametrize("instance", ["wgmma", "fma"])
@pytest.mark.parametrize("case", HEAD_DIM_256)
def test_head_dim_256_backward_instances_match_plain(cuda, case, instance):
    """Each instance of the backward at D = 256, forced by name, against
    ``ref.mha_backward`` on the same bf16 inputs (o the plain forward's):
    dq, dk, dv within chip_smoke's bf16 rule, laid out as their inputs,
    two launches equal bit for bit; the wrapper's choice is the tensor-core
    one."""
    B, H, KV, S, Sk, D, causal, window = case
    q, k, v, _, do = chip_smoke.backward_inputs(torch, ops, case, "bfloat16",
                                                cuda, seed=7)
    o = ref.mha(q, k, v, causal=causal, window=window)
    assert ops.flash_backward_instance(q.dtype, D, q, k, v, o, do) == "wgmma"
    kw = dict(causal=causal, window=window, sm_scale=None)
    before = dict(ops.flash_backward_launches)
    got = ops._flash_backward_launch(q, k, v, o, do, instance, **kw)
    again = ops._flash_backward_launch(q, k, v, o, do, instance, **kw)
    assert ops.flash_backward_launches[instance] == before[instance] + 2
    want = ref.mha_backward(q, k, v, o, do, causal=causal, window=window)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert torch.equal(g, a)
        assert g.stride() == t.stride()
        assert chip_smoke.backward_deviation(torch, g, w, "bfloat16")[2] <= 1


# (B, H, KV, S, Sk, D, causal, window, splits): glm4-9b's (32/2) and
# command-r-35b's (64/8) head layouts at D = 128, causal, at the shortest
# length where pass B of the backward splits the group (a block's chain
# past ops.BACKWARD_CHAIN_B k16 steps), and granite-moe-1b-a400m's (16/8)
# at D = 64, whose group of 2 stays in one block
REGISTRY_BACKWARD = [
    (1, 32, 2, 2048, 2048, 128, True, None, 2),
    (1, 64, 8, 4096, 4096, 128, True, None, 2),
    (1, 16, 8, 2048, 2048, 64, True, None, 1),
]


@pytest.mark.parametrize("case", REGISTRY_BACKWARD)
def test_backward_at_registry_head_layouts_matches_plain(cuda, case):
    """The backward at the last three configurations' head layouts, the
    wrapper's own choice: the tensor-core instance with pass B in the
    splits ``ops.backward_splits`` names, dq, dk, dv within chip_smoke's
    bf16 rule of ``ref.mha_backward`` (delta given, as the training path
    gives it), laid out as their inputs, two launches equal bit for bit.
    Every other divisor of the group gives results within the rule too."""
    B, H, KV, S, Sk, D, causal, window, splits = case
    case = case[:8]
    q, k, v, _, do = chip_smoke.backward_inputs(torch, ops, case, "bfloat16",
                                                cuda, seed=9)
    o = ref.mha(q, k, v, causal=causal)
    delta = (do.float() * ref.mha(q.float(), k.float(), v.float(),
                                  causal=causal)).sum(-1)
    assert ops.backward_splits(H, KV, S, D, "wgmma") == splits
    before = dict(ops.flash_backward_launches)
    got = ops.flash_attention_backward(q, k, v, o, do, causal=causal,
                                       delta=delta)
    again = ops.flash_attention_backward(q, k, v, o, do, causal=causal,
                                         delta=delta)
    assert ops.flash_backward_launches["wgmma"] == before["wgmma"] + 2
    want = ref.mha_backward(q, k, v, o, do, causal=causal, delta=delta)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert torch.equal(g, a)
        assert g.stride() == t.stride()
        assert chip_smoke.backward_deviation(torch, g, w, "bfloat16")[2] <= 1
    for other in (s for s in range(2, H // KV + 1)
                  if (H // KV) % s == 0 and s != splits):
        forced = ops._flash_backward_launch(q, k, v, o, do, "wgmma",
                                            causal=causal, window=None,
                                            sm_scale=None, delta=delta,
                                            splits=other)
        assert torch.equal(forced[0], got[0])       # pass A: dq unchanged
        for g, w in zip(forced[1:], want[1:]):
            assert chip_smoke.backward_deviation(torch, g, w,
                                                 "bfloat16")[2] <= 1


def test_backward_split_keeps_earlier_shapes(cuda):
    """qwen3-14b's head layout (40/8, D = 128) at its training length keeps
    the whole group in one block of pass B, as before the split came:
    the wrapper's result equals the unsplit instance's (splits 1, forced)
    bit for bit, with no partial sums; a split the group does not divide
    is refused before any launch."""
    case = (1, 40, 8, 4096, 4096, 128, True, None)
    q, k, v, o, do = chip_smoke.backward_inputs(torch, ops, case, "bfloat16",
                                                cuda, seed=10)
    assert ops.backward_splits(40, 8, 4096, 128, "wgmma") == 1
    assert ops.backward_partials_floats(1, 8, 1, 4096, 128) == 0
    got = ops.flash_attention_backward(q, k, v, o, do, causal=True)
    kw = dict(causal=True, window=None, sm_scale=None)
    whole = ops._flash_backward_launch(q, k, v, o, do, "wgmma", splits=1,
                                       **kw)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="divisor"):
        ops._flash_backward_launch(q, k, v, o, do, "wgmma", splits=3, **kw)
    assert ops.launches == before


@pytest.mark.parametrize("fault", ["base", "stride"])
def test_misaligned_bf16_at_head_dim_256_takes_the_fma_instance(cuda, fault):
    """At D = 256 a bf16 q 2 bytes off a 16-byte boundary, or with a row
    pitch of 260 elements, sends the forward and the backward to the
    fp32-FMA instance (one launch each, within the limits); the
    tensor-core instance forced by name refuses it before any launch."""
    case = (1, 10, 1, 300, 300, 256, True, 128)
    q, k, v, _, do = chip_smoke.backward_inputs(torch, ops, case, "bfloat16",
                                                cuda, seed=8)
    if fault == "base":
        bad = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=cuda)[1:].view(q.shape)
    else:
        bad = torch.empty(*q.shape[:3], 260, dtype=q.dtype,
                          device=cuda)[..., :256]
    bad.copy_(q)
    kw = dict(causal=True, window=128)
    ops.reset_launches()
    got = ops.flash_attention(bad, k, v, **kw)
    assert ops.flash_launches == {"wgmma": 0, "fma": 1}
    assert chip_smoke.flash_deviation(
        torch, got, ref.mha(bad, k, v, **kw), "bfloat16")[1] <= 1
    o = ref.mha(bad, k, v, **kw)
    grads = ops.flash_attention_backward(bad, k, v, o, do, **kw)
    assert ops.flash_backward_launches == {"wgmma": 0, "fma": 1}
    for g, w in zip(grads, ref.mha_backward(bad, k, v, o, do, **kw)):
        assert chip_smoke.backward_deviation(torch, g, w, "bfloat16")[2] <= 1
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="16"):
        ops._flash_launch(bad, k, v, "wgmma", sm_scale=None, **kw)
    with pytest.raises(ValueError, match="16"):
        ops._flash_backward_launch(bad, k, v, o, do, "wgmma", sm_scale=None,
                                   **kw)
    assert ops.launches == before


def test_hybrid_training_at_head_dim_256_runs_on_the_tensor_cores(cuda):
    """A reduced recurrentgemma step in bf16 at D = 256 with a window
    shorter than S: the flash forward twice an attention layer (the pass
    and its remat) and the backward once, every launch on the tensor-core
    instances, no plain attention reached, finite gradients."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import attention, model
    cfg = dataclasses.replace(
        configs.get_reduced("recurrentgemma_2b", num_layers=5,
                            head_dim=256), sliding_window=64,
        param_dtype="bfloat16")
    lm = model.init_params(cfg, seed=0, device=cuda, trainable=True)
    batch = next(token_stream(cfg, 2, 200, seed=1, device=cuda))
    attn = chip_smoke.kernel_layers(cfg)
    ops.reset_launches()
    with chip_smoke.counted_plain(ref, attention) as calls:
        loss = model.loss_fn(lm, batch, cfg)
        loss.backward()
    assert sum(calls.values()) == 0
    assert ops.flash_launches == {"wgmma": 2 * attn, "fma": 0}
    assert ops.flash_backward_launches == {"wgmma": attn, "fma": 0}
    assert all(bool(torch.isfinite(p.grad).all())
               for p in lm.parameters())


def test_bf16_training_backward_runs_on_the_tensor_cores(cuda):
    """A reduced qwen3 step in bf16 (D = 64): every backward launch on the
    tensor-core instance, one a layer, no plain attention reached, finite
    gradients."""
    from repro_torch import configs
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import attention, model
    cfg = configs.get_reduced("qwen3_14b", param_dtype="bfloat16")
    lm = model.init_params(cfg, seed=0, device=cuda, trainable=True)
    batch = next(token_stream(cfg, 2, 200, seed=1, device=cuda))
    ops.reset_launches()
    with chip_smoke.counted_plain(ref, attention) as calls:
        loss = model.loss_fn(lm, batch, cfg)
        loss.backward()
    assert sum(calls.values()) == 0
    assert ops.flash_backward_launches == {"wgmma": cfg.num_layers,
                                           "fma": 0}
    assert ops.launches["flash_attention_backward"] == cfg.num_layers
    assert all(bool(torch.isfinite(p.grad).all())
               for p in lm.parameters())


def test_training_through_the_kernels_on_the_card(cuda, monkeypatch):
    """A reduced qwen3 step on the card: the flash forward twice a layer
    (pass and remat), the backward once, no plain attention reached, and
    loss and grads near the same step with the plain attention (fp32)."""
    from repro_torch import configs
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import attention, model
    cfg = configs.get_reduced("qwen3_14b")
    lm = model.init_params(cfg, seed=0, device=cuda, trainable=True)
    batch = next(token_stream(cfg, 2, 96, seed=0, device=cuda))

    def run():
        lm.zero_grad(set_to_none=True)
        loss = model.loss_fn(lm, batch, cfg)
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in lm.named_parameters()}

    ops.reset_launches()
    with chip_smoke.counted_plain(ref, attention) as calls:
        loss, grads = run()
    assert sum(calls.values()) == 0
    assert ops.launches["flash_attention"] == 2 * cfg.num_layers
    assert ops.launches["flash_attention_backward"] == cfg.num_layers
    monkeypatch.setattr(attention, "self_attend",
                        chip_smoke.plain_self_attend)
    loss_p, grads_p = run()
    assert abs(float(loss) - float(loss_p)) <= 1e-5
    for n, g in grads.items():
        scale = float(grads_p[n].abs().max())
        assert float((g - grads_p[n]).abs().max()) <= 1e-4 * max(scale, 1e-30)


def test_mamba2_training_step_on_the_card(cuda, monkeypatch):
    """A reduced mamba2 step on the card (fp32, chunk 16): ssd_scan twice a
    layer (pass and remat), ssd_scan_backward once, no plain scan reached;
    loss and grads (A_log, D and dt_bias among them) near the same step
    with the plain scan under torch autograd."""
    from repro_torch import configs
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import model, ssm
    cfg = configs.get_reduced("mamba2_370m")
    lm = model.init_params(cfg, seed=0, device=cuda, trainable=True)
    batch = next(token_stream(cfg, 2, 100, seed=0, device=cuda))

    def run():
        lm.zero_grad(set_to_none=True)
        loss = model.loss_fn(lm, batch, cfg)
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in lm.named_parameters()
                               if p.grad is not None}

    ops.reset_launches()
    with chip_smoke.counted_plain_scan(ref, ssm) as calls:
        loss, grads = run()
    assert sum(calls.values()) == 0
    assert ops.launches["ssd_scan"] == 2 * cfg.num_layers
    assert ops.launches["ssd_scan_backward"] == cfg.num_layers
    assert any(n.endswith("A_log") for n in grads)
    monkeypatch.setattr(ssm, "ssd", chip_smoke.autograd_ssd)
    loss_p, grads_p = run()
    assert set(grads) == set(grads_p)
    assert abs(float(loss) - float(loss_p)) <= 1e-5
    for n, g in grads.items():
        scale = float(grads_p[n].abs().max())
        assert float((g - grads_p[n]).abs().max()) <= 1e-4 * max(scale, 1e-30)


@pytest.mark.parametrize("dfinal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 200, 3, 32, 64, 64),
                                  (1, 1999, 32, 64, 128, 64)])
def test_ssd_backward_matches_plain(cuda, case, dtype, dfinal):
    """The backward kernel against ``ref.ssd_scan_backward`` within
    chip_smoke's limits (fp32 a share of each max |grad|; bf16 dx, dB, dC
    one ulp beyond it), mamba2-370m's shape as the model's strided slices
    (1999: a ragged last chunk); two launches equal bit for bit."""
    args = chip_smoke.ssd_backward_inputs(torch, case, dtype, cuda, seed=6,
                                          dfinal=dfinal)
    before = ops.launches["ssd_scan_backward"]
    got = ops.ssd_scan_backward(*args, chunk=case[5])
    again = ops.ssd_scan_backward(*args, chunk=case[5])
    assert ops.launches["ssd_scan_backward"] == before + 2
    want = ref.ssd_scan_backward(*args, chunk=case[5])
    for name, g, a, w in zip(chip_smoke.SSD_GRADS, got, again, want):
        assert torch.equal(g, a)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert chip_smoke.ssd_backward_deviation(torch, name, g, w,
                                                 dtype)[2] <= 1.0


@pytest.mark.parametrize("instance", ["wgmma", "fma"])
@pytest.mark.parametrize("dfinal", [False, True])
@pytest.mark.parametrize("case", [
    c for c in chip_smoke.SSD_BACKWARD_CASES
    if c[5] == 64 and c[3] % 16 == 0 and c[4] % 16 == 0
    and c[0] * c[1] <= 4096])
def test_ssd_backward_instances_match_plain(cuda, case, dfinal, instance):
    """Each instance of ``ssd_scan_backward`` forced by name on bf16
    inputs the tensor-core one takes (chip_smoke's cases at chunk 64, the
    model's strided slices) against ``ref.ssd_scan_backward`` within
    phase 17's limits; two launches equal bit for bit, counted on the
    instance."""
    assert ops.ssd_backward_instance(torch.bfloat16, *case[3:]) == "wgmma"
    args = chip_smoke.ssd_backward_inputs(torch, case, "bfloat16", cuda,
                                          seed=8, dfinal=dfinal)
    assert ops.ssd_backward_instance(torch.bfloat16, *case[3:], args[0],
                                     args[3], args[4], args[6]) == "wgmma"
    ops.reset_launches()
    got = ops._ssd_backward_launch(*args, case[5], instance)
    again = ops._ssd_backward_launch(*args, case[5], instance)
    assert ops.ssd_backward_launches == {
        k: 2 * (k == instance) for k in ops.SSD_BACKWARD_INSTANCES}
    assert ops.launches["ssd_scan_backward"] == 2
    want = ref.ssd_scan_backward(*args, chunk=case[5])
    for name, g, a, w in zip(chip_smoke.SSD_GRADS, got, again, want):
        assert torch.equal(g, a), name
        assert g.dtype == w.dtype and g.shape == w.shape
        assert chip_smoke.ssd_backward_deviation(torch, name, g, w,
                                                 "bfloat16")[2] <= 1.0, name


def test_ssd_backward_wrapper_takes_the_tensor_core_instance(cuda):
    """mamba2-370m's bf16 slices at chunk 64: the wrapper launches
    ``"wgmma"``; fp32 inputs and chunk 32 take ``"fma"``."""
    case = (1, 130, 32, 64, 128, 64)
    ops.reset_launches()
    for dtype, chunk, inst in (("bfloat16", 64, "wgmma"),
                               ("float32", 64, "fma"),
                               ("bfloat16", 32, "fma")):
        args = chip_smoke.ssd_backward_inputs(
            torch, case[:5] + (chunk,), dtype, cuda, seed=9, dfinal=False)
        before = dict(ops.ssd_backward_launches)
        ops.ssd_scan_backward(*args, chunk=chunk)
        assert ops.ssd_backward_launches[inst] == before[inst] + 1


def test_ssd_backward_forced_tensor_core_raises_before_a_launch(cuda):
    """A forced ``"wgmma"`` on operands it does not take raises ValueError
    before any launch: fp32, chunk 128, a base off 16 bytes."""
    case = (1, 256, 2, 16, 32, 64)
    f32 = chip_smoke.ssd_backward_inputs(torch, case, "float32", cuda,
                                         seed=4, dfinal=False)
    bf = list(chip_smoke.ssd_backward_inputs(torch, case, "bfloat16", cuda,
                                             seed=4, dfinal=False))
    flat = torch.zeros(bf[0].numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(bf[0].shape)
    before = (dict(ops.launches), dict(ops.ssd_backward_launches))
    for args, chunk in ((f32, 64), (bf, 128), ([shifted] + bf[1:], 64)):
        with pytest.raises(ValueError):
            ops._ssd_backward_launch(*args, chunk, "wgmma")
    assert (dict(ops.launches), dict(ops.ssd_backward_launches)) == before


def test_ssd_scan_under_grad_on_the_card_has_a_gradient(cuda):
    """ops.ssd_scan with an input that requires grad goes through SSDScan:
    the output carries a graph, and its backward is one kernel launch;
    without grad it is one forward launch and no graph."""
    x, dt, A, B, C, D = chip_smoke.ssd_inputs(
        torch, (1, 130, 32, 64, 128, 64), "bfloat16", cuda, seed=7)
    x = x.detach().requires_grad_(True)
    ops.reset_launches()
    with torch.no_grad():
        y, final = ops.ssd_scan(x, dt, A, B, C, D, chunk=64)
    assert y.grad_fn is None and ops.launches["ssd_scan"] == 1
    y, final = ops.ssd_scan(x, dt, A, B, C, D, chunk=64)
    assert y.grad_fn is not None and final.grad_fn is not None
    y.float().sum().backward()
    assert ops.launches["ssd_scan"] == 2
    assert ops.launches["ssd_scan_backward"] == 1
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_ssd_backward_raises_on_bad_operands_before_a_launch(cuda):
    """Bad operands raise before any launch: a chunk the blocks cannot
    take, a dy of another dtype, device or stride, a dfinal of another
    shape."""
    args = list(chip_smoke.ssd_backward_inputs(
        torch, (1, 70, 2, 8, 16, 16), "float32", cuda, seed=2, dfinal=True))
    before = dict(ops.launches)
    bad = [(dict(chunk=12), ValueError),
           (dict(args=args[:6] + [args[6].double(), args[7]]), TypeError),
           (dict(args=args[:6] + [args[6].cpu(), args[7]]), TypeError),
           (dict(args=args[:6] + [args[6].transpose(2, 3), args[7]]),
            ValueError),
           (dict(args=args[:7] + [args[7][..., :8]]), ValueError)]
    for change, err in bad:
        with pytest.raises(err):
            ops.ssd_scan_backward(*change.get("args", args),
                                  chunk=change.get("chunk", 16))
    assert ops.launches == before


def test_flash_backward_raises_without_its_library(cuda, monkeypatch,
                                                    tmp_path):
    """A CUDA tensor gets the backward kernel or an error — never the
    plain version."""
    from repro_torch.kernels import build
    q = torch.randn(1, 4, 64, 32, device=cuda)
    k = torch.randn(1, 2, 64, 32, device=cuda)
    monkeypatch.setitem(build.SOURCES, "flash_backward",
                        tmp_path / "missing.cu")
    monkeypatch.delitem(build._loaded, "flash_backward", raising=False)
    ops._flash_backward_lib.cache_clear()
    before = dict(ops.launches)
    try:
        with pytest.raises((OSError, RuntimeError)):
            ops.flash_attention_backward(q, k, k, q, q)
    finally:
        ops._flash_backward_lib.cache_clear()
    assert ops.launches == before


def test_ssd_backward_raises_without_its_library(cuda, monkeypatch,
                                                  tmp_path):
    """A CUDA tensor gets the SSD backward kernel or an error — never the
    plain version."""
    from repro_torch.kernels import build
    args = chip_smoke.ssd_backward_inputs(torch, (1, 70, 2, 8, 16, 16),
                                          "float32", cuda, seed=3,
                                          dfinal=False)
    monkeypatch.setitem(build.SOURCES, "ssd_backward",
                        tmp_path / "missing.cu")
    monkeypatch.delitem(build._loaded, "ssd_backward", raising=False)
    ops._ssd_backward_lib.cache_clear()
    before = dict(ops.launches)
    try:
        with pytest.raises((OSError, RuntimeError)):
            ops.ssd_scan_backward(*args, chunk=16)
    finally:
        ops._ssd_backward_lib.cache_clear()
    assert ops.launches == before


def test_sharded_step_at_one_rank_on_the_card(cuda):
    """The sharded train step on a mesh of one rank on the card (reduced
    qwen3-14b in fp32, the kernels' fp32 instances) against
    ``make_train_step`` from the same weights and batches: two steps,
    loss, gnorm, weights and moments within 1e-5."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = dataclasses.replace(configs.get_reduced("qwen3_14b"),
                              param_dtype="float32")
    mesh = M.make_host_mesh()
    ref = model.init_params(cfg, seed=2, device=cuda, trainable=True)
    state = adamw_init(ref)
    lm = shd.init_sharded(cfg, mesh, seed=2, device=cuda)
    ostate = shd.init_opt_state(cfg, mesh, cuda)
    stream = token_stream(cfg, 2, 64, seed=1, device=cuda)
    first = next(stream)
    one = train.make_train_step(cfg, AdamWConfig(lr=1e-3), total_steps=10)
    step, _ = train.make_jitted_train_step(cfg, AdamWConfig(lr=1e-3), mesh,
                                           first, total_steps=10)
    ops.reset_launches()
    for b in (first, next(stream)):
        _, state, m1 = one(ref, state, b)
        with M.bound(mesh):
            _, ostate, m2 = step(lm, ostate, b)
        for k in ("loss", "gnorm"):
            assert abs(float(m1[k]) - float(m2[k])) <= 1e-5 * max(
                1.0, float(m1[k]))
    assert ops.launches["flash_attention_backward"] == 4 * cfg.num_layers
    whole = shd.gather_params(lm)
    for name, p in ref.named_parameters():
        assert (whole[name] - p).abs().max() <= 1e-5, name
        for key in ("m", "v"):
            assert (ostate[key][name] - state[key][name]).abs().max() \
                <= 1e-5, (key, name)


@pytest.mark.parametrize("arch", ["qwen3_14b", "mamba2_370m"])
def test_remat_policies_on_the_card(cuda, arch):
    """"dots" and "names" give "full"'s loss and gradients bit for bit on
    the card (bf16, the kernels' tensor-core instances), and launch the
    flash (or SSD) forward twice a layer: its output is recomputed."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import model
    cfg = configs.get_reduced(arch)
    batch = next(token_stream(cfg, 2, 128, seed=5, device=cuda))
    lm = model.init_params(cfg, seed=0, device=cuda, trainable=True)
    runs = {}
    for policy in ("full", "dots", "names"):
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        lm.zero_grad(set_to_none=True)
        ops.reset_launches()
        loss = model.loss_fn(lm, batch, pcfg)
        loss.backward()
        kernel = "ssd_scan" if arch == "mamba2_370m" else "flash_attention"
        assert ops.launches[kernel] == 2 * cfg.num_layers, ops.launches
        runs[policy] = (loss.detach(), {n: p.grad.clone() for n, p in
                                        lm.named_parameters()
                                        if p.grad is not None})
    for policy in ("dots", "names"):
        assert torch.equal(runs[policy][0], runs["full"][0])
        assert runs[policy][1].keys() == runs["full"][1].keys()
        for name, g in runs["full"][1].items():
            assert torch.equal(runs[policy][1][name], g), (policy, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,over", [
    ("qwen3_14b", {}), ("qwen3_14b", {"kv_cache_dtype": "int8"}),
    ("command_r_35b", {}), ("granite_moe_1b_a400m", {}),
    ("granite_moe_1b_a400m", {"moe_routing": "scatter"}),
    ("mamba2_370m", {}),
    ("recurrentgemma_2b", {"num_layers": 3, "sliding_window": 8}),
    ("seamless_m4t_large_v2", {})])
def test_tensor_parallel_decode_at_model_1_is_the_one_card_decode(
        cuda, arch, over, dtype):
    """At a model axis of 1 the tensor-parallel block functions
    (``models.tp``) and the sharded serve step do the one-card decode's
    arithmetic on the card: every layer's output and cache, and each
    step's logits, equal ``blocks.block_decode`` and ``make_serve_step``
    bit for bit over 10 steps (the ring of the windowed cache wraps)."""
    import copy
    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as shd
    from repro_torch.models import blocks, layers, model, tp
    from repro_torch.models.prefill import prefill
    cfg = configs.get_reduced(arch, param_dtype=dtype, **over)
    lm = model.init_params(cfg, seed=3, device=cuda)
    B, L = 3, 16
    tok = torch.tensor([3, 11, 7], device=cuda)
    if cfg.is_encoder_decoder:
        media = torch.randn(B, cfg.frontend_len, cfg.d_model, device=cuda,
                            generator=torch.Generator(cuda).manual_seed(4))
        _, cache, p0 = prefill(lm, {"tokens": tok[:, None].repeat(1, 2),
                                    "enc_media": media}, cfg, L)
    else:
        cache, p0 = model.init_cache(cfg, B, L, device=cuda), 0
    mesh = M.make_host_mesh()
    step, _ = serve.make_jitted_serve_step(cfg, mesh, B, L)
    one = serve.make_serve_step(cfg)
    mine = copy.deepcopy(cache)
    leaves, _ = serve.serve_leaves(lm, mesh)
    kinds = blocks.block_kinds(cfg)
    for t in range(10):
        # each layer alone, from the same input and copies of its cache
        x = layers.apply_norm(lm.embed[tok][:, None], lm.final_norm,
                              cfg.norm)
        with M.bound(mesh), torch.no_grad():
            for i, kind in enumerate(kinds):
                want_c = {n: v.clone() for n, v in
                          model.layer_cache(cache, i, cfg).items()}
                got_c = {n: v.clone() for n, v in want_c.items()}
                kv = (None if "cross_kv" not in cache else
                      {n: v[i] for n, v in cache["cross_kv"].items()})
                want, _ = blocks.block_decode(
                    lm.layers[i], x, want_c, p0 + t, cfg, kind,
                    window=cfg.sliding_window, cross_kv=kv)
                got, _ = tp.block_decode(
                    leaves.layers[i], x, got_c, p0 + t, cfg, kind,
                    {n: False for n in list(got_c) + ["cross"]},
                    window=cfg.sliding_window, cross_kv=kv)
                assert torch.equal(got, want), (t, i)
                for n in want_c:
                    assert torch.equal(got_c[n], want_c[n]), (t, i, n)
        with M.bound(mesh), torch.no_grad():
            a, la, mine = step(lm, mine, tok, p0 + t)
        b, lb, cache = one(lm, cache, tok, p0 + t)
        assert torch.equal(la, lb) and torch.equal(a, b), t
        tok = b.long()
