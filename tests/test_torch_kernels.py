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

from _torch_cases import (ROUND_CASES, problem as _problem,
                          segments as _segments, stream_x_pass,
                          sum_in_order)
from _torch_cases import one_thread  # noqa: F401

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


def test_reset_launches_zeroes_the_round_instances():
    """The per-instance counts of the round kernel start from 0 with the
    others, and the CPU wrapper never moves them."""
    ops.round_block_launches["stream"] += 3
    ops.reset_launches()
    assert ops.round_block_launches == {"stream": 0, "direct": 0}
    assert tuple(ops.round_block_launches) == ops.ROUND_INSTANCES
    d = _t(_problem(2, 5, 4))
    ops.csvm_round_block(d["X"], d["y"], d["B"], d["P"], d["W"], d["deg"],
                         d["rho"], d["omega"], d["lam"],
                         torch.tensor(1, dtype=torch.int32), tau=1.0,
                         lam0=0.0, h=0.3)
    assert ops.round_block_launches == {"stream": 0, "direct": 0}


@pytest.mark.parametrize("m,n,p,dtype,rounds", [
    (5, 13, 37, torch.float32, 1),
    (5, 13, 37, torch.bfloat16, 4),
    (16, 1024, 4096, torch.float32, 300),
    (16, 1024, 4096, torch.bfloat16, 4),
    (10, 200, 101, torch.float32, 7),
])
def test_round_block_bytes_match_the_wrapper_buffers(m, n, p, dtype, rounds):
    """The residency rule's byte count is exactly the operands the wrapper
    checks plus the outputs, scratch and plan it allocates (on the meta
    device: shapes only, no memory), for each instance — the stream
    instance's partial rows at the grid of an H100 (132 SMs, one block
    each) and at one block."""
    meta = torch.device("meta")
    f32 = dict(dtype=torch.float32, device=meta)
    operands = [torch.empty((m, n, p), dtype=dtype, device=meta),
                torch.empty((m, n), **f32), torch.empty((m, p), **f32),
                torch.empty((m, p), **f32), torch.empty((m, m), **f32),
                torch.empty((m,), **f32), torch.empty((m,), **f32),
                torch.empty((m,), **f32), torch.empty((p,), **f32),
                torch.empty((), dtype=torch.int32, device=meta)]
    h100 = ops.round_stream_grid(m, n, p, dtype.itemsize, 1, 132)
    for instance, grid in (("direct", 1), ("stream", h100), ("stream", 1)):
        buffers = ops._round_block_buffers(*operands, rounds, instance, grid)
        assert len(buffers) == (5 if instance == "stream" else 4)
        total = sum(t.numel() * t.element_size()
                    for t in operands + list(buffers))
        assert total == ops.round_block_bytes(m, n, p, dtype.itemsize,
                                              rounds, instance, grid)
        assert buffers[3].numel() == ops.round_block_scratch_floats(
            m, n, p, rounds, instance, grid)
    # the stream instance's partial rows: one per node segment, at most
    # grid + m - 1 of them
    nseg = ops.round_stream_plan(m, n, h100)[2][-1]
    assert max(h100, m) <= nseg <= h100 + m - 1
    assert ops.round_block_scratch_floats(m, n, p, rounds, "stream", h100) \
        == m * p + p + rounds + 2 + nseg * p


def test_round_block_instance_table():
    """The stream instance takes p up to the 8192 columns its 512 consumer
    threads hold, 16 each (the ring then fits a block's shared memory at
    both dtypes); the direct instance takes the rest."""
    for dtype in (torch.float32, torch.bfloat16):
        assert ops.round_block_instance(16, 1024, 4096, dtype) == "stream"
        assert ops.round_block_instance(10, 200, 101, dtype) == "stream"
        assert ops.round_block_instance(2, 3, 1, dtype) == "stream"
        assert ops.round_block_instance(2, 3, 8192, dtype) == "stream"
        assert ops.round_block_instance(2, 3, 8193, dtype) == "direct"
        assert ops.round_stream_smem_bytes(8192, dtype.itemsize) <= \
            ops._SMEM_LIMIT - ops._STATIC_SMEM
    assert ops.STREAM_MAX_P == 8192
    # the main path's tiles: 4 fp32 rows or 8 bf16 rows of 16 KB / 8 KB,
    # 64 KB a stage, three stages
    assert ops.round_stream_tile_rows(4096, 4) == 4
    assert ops.round_stream_tile_rows(4096, 2) == 8
    assert ops.round_stream_smem_bytes(4096, 4) == 3 * 65664 + 2432
    assert ops.round_stream_tile_rows(101, 4) == 32       # the row cap
    assert ops.round_stream_tile_rows(8192, 4) == 2
    # the grid: every co-resident block, no more blocks than tiles' worth
    # of rows
    assert ops.round_stream_grid(16, 1024, 4096, 4, 1, 132) == 132
    assert ops.round_stream_grid(16, 1024, 4096, 4, 2, 132) == 264
    assert ops.round_stream_grid(10, 200, 101, 4, 1, 132) == 63
    assert ops.round_stream_grid(5, 13, 37, 4, 1, 132) == 3


@pytest.mark.parametrize("m,n,grid", [(5, 13, 3), (3, 20, 1), (4, 45, 6),
                                      (3, 50, 5), (16, 1024, 132),
                                      (2, 3, 6), (7, 11, 13)])
def test_round_stream_plan_splits_rows_into_node_segments(m, n, grid):
    """Contiguous ranges that cover the m*n rows in order, as even as
    integers allow; each range split at node boundaries into segments
    numbered in row order, so a node's segments are consecutive and in
    block order."""
    rows, seg0, node_seg = ops.round_stream_plan(m, n, grid)
    assert rows[0] == 0 and rows[-1] == m * n and len(rows) == grid + 1
    sizes = [b - a for a, b in zip(rows, rows[1:])]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    segs = _segments(rows, n)
    assert [seg for seg, _ in enumerate(segs)
            if segs[seg][1] in rows[:-1]] == seg0
    assert node_seg[0] == 0 and node_seg[-1] == len(segs)
    for l in range(m):
        own = segs[node_seg[l]:node_seg[l + 1]]
        assert own and all(s[0] == l for s in own)
        assert own[0][1] == l * n and own[-1][2] == (l + 1) * n
        assert all(a[2] == b[1] for a, b in zip(own, own[1:]))
    with pytest.raises(ValueError):
        ops.round_stream_plan(m, n, m * n + 1)


def _stream_model(X, y, B, P, W, deg, rho, omega, lam_vec, nact, *, tau,
                  lam0, h, kernel, num_rounds, want_kkt, grid):
    """The stream instance's arithmetic order in plain torch: per node
    segment of the wrapper's plan, the margins at round(b), w = round(
    L_h'(y m) y scale) and the partial X^T w row; each node's partial rows
    summed in block order; W@B once a round, the previous round's dual
    update folded into the next round and the last one applied after the
    loop; the KKT pass at beta_bar with the partial rows summed in
    segment order."""
    m, n, p = X.shape
    rows, _, node_seg = ops.round_stream_plan(m, n, grid)
    segs = _segments(rows, n)
    x_pass = lambda bsrc, scale: stream_x_pass(X, y, bsrc, scale, segs,
                                               kernel, h)
    in_order = lambda parts: sum_in_order(parts, p)

    nact = min(max(int(nact), 0), num_rounds)
    delta = torch.tensor(float("inf"))
    soft = lambda v, t: torch.sign(v) * torch.clamp(v.abs() - t, min=0.0)
    for r in range(nact):
        parts = x_pass(B, 1.0 / n)
        g = torch.stack([in_order(parts[node_seg[l]:node_seg[l + 1]])
                         for l in range(m)])
        WB = W @ B
        if r > 0:
            P = P + tau * (deg[:, None] * B - WB)
        z = rho[:, None] * B - g - P + tau * (deg[:, None] * B + WB)
        Bn = soft(omega[:, None] * z, lam_vec[None, :] * omega[:, None])
        delta = torch.max(torch.abs(Bn - B))
        B = Bn
    if nact > 0:
        P = P + tau * (deg[:, None] * B - W @ B)
    if not want_kkt:
        return B, P, delta
    bb = torch.sum(B, dim=0) * (1.0 / m)
    cons = torch.max(torch.abs(B - bb[None, :]))
    g = in_order(x_pass(bb.expand(m, -1), 1.0)) * ((1.0 / n) / m)
    g = g + lam0 * bb
    stat = torch.max(torch.abs(bb - soft(bb - g, lam_vec)))
    return B, P, torch.maximum(stat, cons)


@pytest.mark.parametrize("grid", ["h100", 1, 7, "rows"])
@pytest.mark.parametrize("case", ROUND_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_instance_order_matches_plain(case, dtype, grid):
    """The stream instance's order of arithmetic (``_stream_model``, on the
    wrapper's partition) holds to the plain version the wrappers run on
    the CPU: fp32 within 1e-5, bf16 within the kernel tier, held rounds
    bit-exact; at the grid an H100 gives each case, at one block, at 7 and
    at one row per block."""
    m, n, p, R, nact, kkt, lam0, lam_vector, kernel = case
    d = _problem(m, n, p, seed=m + n + p)
    if not lam_vector:
        d["lam"] = np.full(p, 0.01, np.float32)
    t = _t(d)
    tdt = getattr(torch, dtype)
    if grid == "h100":
        g = ops.round_stream_grid(m, n, p, tdt.itemsize, 1, 132)
    else:
        g = m * n if grid == "rows" else min(grid, m * n)
    args = (t["X"].to(tdt), t["y"], t["B"], t["P"], t["W"], t["deg"],
            t["rho"], t["omega"], t["lam"], nact)
    kw = dict(tau=1.0, lam0=lam0, h=0.35, kernel=kernel, num_rounds=R,
              want_kkt=kkt)
    got = _stream_model(*args, grid=g, **kw)
    want = cu.csvm_round_block_plain(*args, **kw)
    tol = ATOL if dtype == "float32" else ATOL_BF16_KERNEL
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy(), tol)
    if nact == 0:
        assert torch.equal(got[0], t["B"]) and torch.equal(got[1], t["P"])


def test_new_round_cases_cross_node_boundaries_on_an_h100():
    """The two newest ROUND_CASES give the stream instance, at its own grid
    on an H100, block ranges that cross node boundaries (so a node's
    X^T w comes from partial rows of two blocks)."""
    for m, n, p, *_ in ROUND_CASES[-2:]:
        for itemsize in (4, 2):
            grid = ops.round_stream_grid(m, n, p, itemsize, 1, 132)
            rows = ops.round_stream_plan(m, n, grid)[0]
            assert any(a // n != (b - 1) // n for a, b in zip(rows, rows[1:]))


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


def test_chip_smoke_reads_the_stream_build():
    """chip_smoke.py's readers of the round kernel's stream instance: the
    ptxas line with its static shared memory, and cuobjdump's bulk-copy
    count per instance."""
    import chip_smoke
    log = ("ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5b54f3"
           "47_14_csvm_update_cu_841b4c2819round_stream_kernelIfEEvNS_4Args"
           "IT_EE' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
           "\nptxas info    : Used 112 registers, used 2 barriers, 68 bytes "
           "smem\n"
           "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118"
           "round_block_kernelIfEEvNS_4ArgsIT_EE' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
           "\nptxas info    : Used 48 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_report(log) == [
        ("round_stream_kernel<float>", 112,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("round_block_kernel<float>", 48,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
    assert chip_smoke.ptxas_smem(log) == {"round_stream_kernel<float>": 68,
                                          "round_block_kernel<float>": 0}
    sass = ("\t\tFunction : _ZN12_GLOBAL__N_119round_stream_kernelI13__nv_"
            "bfloat16EEvNS_4ArgsIT_EE\n"
            "        /*0100*/  UBLKCP.S.G [UR8], [UR4], UR6 ;\n"
            "        /*0200*/  SYNCS.ARRIVE.TRANS64 RZ, [UR8], RZ ;\n"
            "\t\tFunction : _ZN12_GLOBAL__N_118round_block_kernelIfEEvNS_4"
            "ArgsIT_EE\n"
            "        /*0100*/  FFMA R1, R2, R3, R1 ;\n")
    assert chip_smoke.sass_counts(sass, ("UBLKCP", "UTMALDG")) == {
        "_ZN12_GLOBAL__N_119round_stream_kernelI13__nv_bfloat16EEvNS_4ArgsI"
        "T_EE": (1, 0),
        "_ZN12_GLOBAL__N_118round_block_kernelIfEEvNS_4ArgsIT_EE": (0, 0)}
