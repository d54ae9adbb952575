"""Torch port, the two-pass CSVM update (``csvm_block_update``,
``csvm_local_update``): the instance rule, the stream instance's buffers,
and its order of arithmetic — one X pass over the row ranges of the
round kernel's plan, each node's partial X^T w rows summed in block order,
then the prox — in plain torch, held to the plain versions the wrappers
run on the CPU and to the JAX package's Pallas kernels in interpret mode.
The CUDA kernels run only on a card: their tests are in
``test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ops as jops
from repro_torch.kernels import csvm_update as cu
from repro_torch.kernels import ops

from _torch_cases import (TWO_PASS_CASES, segments, stream_x_pass,
                          sum_in_order, two_pass_problem)
from _torch_cases import one_thread  # noqa: F401

# fp32: the same fp32 dots summed in another order — the repo's fp32 tier.
ATOL = 1e-5
# bf16 X: both sides round b and w to bf16 at the same points, so they
# differ only where an fp32 summation-order difference moves an operand
# across a bf16 rounding boundary (test_torch_kernels.py's kernel tier).
ATOL_BF16_KERNEL = 1e-4
H = 0.3
GRIDS = ["h100", 1, 7, "rows"]


def _grid(grid, m, n, p, itemsize):
    """A stream launch's grid: an H100's (132 SMs, one block each), or a
    given block count up to one row per block."""
    if grid == "h100":
        return ops.round_stream_grid(m, n, p, itemsize, 1, 132)
    return m * n if grid == "rows" else min(grid, m * n)


def _two_pass_model(X, y, B, P, neigh, rho, omega, lam_vec, *, kernel,
                    grid):
    """The stream instance's order: the partial X^T w row of each node
    segment of the ``grid``-block plan at round(B) and scale 1/n, each
    node's rows summed in block order, then z and the prox."""
    m, n, p = X.shape
    rows, _, node_seg = ops.round_stream_plan(m, n, grid)
    parts = stream_x_pass(X, y, B, 1.0 / n, segments(rows, n), kernel, H)
    g = torch.stack([sum_in_order(parts[node_seg[l]:node_seg[l + 1]], p)
                     for l in range(m)])
    z = rho[:, None] * B - g - P + neigh
    v, t = omega[:, None] * z, lam_vec[None, :] * omega[:, None]
    return torch.sign(v) * torch.clamp(v.abs() - t, min=0.0)


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _pallas_block(case_index, dtype):
    case = TWO_PASS_CASES[case_index]
    j = {k: jnp.asarray(v) for k, v in two_pass_problem(case).items()}
    return np.asarray(jops.csvm_block_update(
        j["X"].astype(getattr(jnp, dtype)), j["y"], j["B"], j["P"],
        j["neigh"], j["rho"], j["omega"], j["lam"], h=H, kernel=case[3]))


@functools.lru_cache(maxsize=None)
def _pallas_local(case_index, scalar_lam):
    """JAX's one-node kernel for each node in turn (JAX vmaps it)."""
    case = TWO_PASS_CASES[case_index]
    j = {k: jnp.asarray(v) for k, v in two_pass_problem(case).items()}
    lam = float(j["lam"][0]) if scalar_lam else j["lam"]
    return np.stack([np.asarray(jops.csvm_local_update(
        j["X"][l], j["y"][l], j["B"][l], j["P"][l], j["neigh"][l],
        j["rho"][l], j["omega"][l], lam, h=H, kernel=case[3]))
        for l in range(case[0])])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case_index", range(len(TWO_PASS_CASES)))
def test_block_update_stream_order_matches_plain_and_pallas(case_index,
                                                            dtype, grid):
    """csvm_block_update in the stream instance's order, at the grid an
    H100 gives the case, at one block, at 7 and at one row per block:
    fp32 within 1e-5, bf16 within the kernel tier (with sign-exact
    support) of the plain version and of JAX's Pallas kernel."""
    case = TWO_PASS_CASES[case_index]
    m, n, p, kernel = case[:4]
    t = _t(two_pass_problem(case))
    tdt = getattr(torch, dtype)
    args = (t["X"].to(tdt), t["y"], t["B"], t["P"], t["neigh"], t["rho"],
            t["omega"], t["lam"])
    got = _two_pass_model(*args, kernel=kernel,
                          grid=_grid(grid, m, n, p, tdt.itemsize))
    plain = ops.csvm_block_update(*args, h=H, kernel=kernel)
    pallas = _pallas_block(case_index, dtype)
    tol = ATOL if dtype == "float32" else ATOL_BF16_KERNEL
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=tol, rtol=0)
    if dtype == "bfloat16":
        supp = np.abs(pallas) > 1e-2
        np.testing.assert_array_equal(np.sign(got.numpy())[supp],
                                      np.sign(pallas)[supp])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("scalar_lam", [True, False])
@pytest.mark.parametrize("case_index", range(len(TWO_PASS_CASES)))
def test_local_update_stream_order_matches_plain_and_pallas(case_index,
                                                            scalar_lam,
                                                            grid):
    """csvm_local_update (fp32 X, each case's smoothing kernel, lambda a
    scalar or a (p,) vector) in the stream instance's order, at the same
    grids, within 1e-5 of the plain version and of JAX's Pallas kernel."""
    case = TWO_PASS_CASES[case_index]
    m, n, p, kernel = case[:4]
    t = _t(two_pass_problem(case))
    lam = float(t["lam"][0]) if scalar_lam else t["lam"]
    args = (t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"], t["omega"])
    got = _two_pass_model(*args, torch.broadcast_to(torch.as_tensor(lam),
                                                    (p,)),
                          kernel=kernel, grid=_grid(grid, m, n, p, 4))
    plain = ops.csvm_local_update(*args, lam, h=H, kernel=kernel)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), _pallas_local(case_index,
                                                          scalar_lam),
                               atol=ATOL, rtol=0)


def test_cases_cross_node_boundaries():
    """At an H100's grid at least one case's block ranges cross a node
    boundary, and at 7 blocks every case's do (a node's X^T w then comes
    from partial rows of two blocks); one case pads rows with y = 0."""
    crossing = lambda m, n, g: any(
        a // n != (b - 1) // n
        for a, b in zip(*(lambda r: (r, r[1:]))(
            ops.round_stream_plan(m, n, g)[0])))
    assert any(crossing(m, n, _grid("h100", m, n, p, 4))
               for m, n, p, *_ in TWO_PASS_CASES)
    assert all(crossing(m, n, 7) for m, n, p, *_ in TWO_PASS_CASES)
    assert any(case[5] for case in TWO_PASS_CASES)
    assert {case[3] for case in TWO_PASS_CASES} == set(
        ["epanechnikov", "laplacian", "gaussian", "uniform", "logistic"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_instance_table(dtype):
    """The stream instance takes what the round kernel's stream instance
    takes (p up to 8192) from a 16-byte-aligned base; the direct instance
    takes the rest."""
    assert ops.two_pass_instance(16, 1024, 4096, dtype) == "stream"
    assert ops.two_pass_instance(16, 1024, 4096, dtype, 2 ** 40) == "stream"
    assert ops.two_pass_instance(2, 3, 8192, dtype) == "stream"
    assert ops.two_pass_instance(10, 200, 101, dtype, 48) == "stream"
    assert ops.two_pass_instance(2, 3, 8193, dtype) == "direct"
    assert ops.two_pass_instance(16, 1024, 4096, dtype, 4) == "direct"
    assert ops.two_pass_instance(16, 1024, 4096, dtype, 8) == "direct"
    assert ops.two_pass_instance(2 ** 16, 2 ** 15, 4, dtype) == "direct"
    assert ops.TWO_PASS_INSTANCES == ("stream", "direct")


@pytest.mark.parametrize("m,n,p,dtype", [
    (5, 13, 37, torch.float32), (16, 1024, 4096, torch.float32),
    (16, 1024, 4096, torch.bfloat16), (10, 200, 101, torch.float32)])
def test_two_pass_scratch_floats_match_the_wrapper_buffers(m, n, p, dtype):
    """The wrapper's buffers (on the meta device: shapes only): B+ and the
    scratch ``two_pass_scratch_floats`` counts — one partial row per node
    segment (between max(grid, m) and grid + m - 1 of them) for the stream
    instance at an H100's grid and at one block, w (m, n) for the direct
    one — and the stream instance's int32 plan."""
    X = torch.empty((m, n, p), dtype=dtype, device="meta")
    h100 = _grid("h100", m, n, p, dtype.itemsize)
    for instance, grid in (("stream", h100), ("stream", 1), ("direct", 1)):
        bufs = ops._two_pass_buffers(X, instance, grid)
        assert len(bufs) == (3 if instance == "stream" else 2)
        assert tuple(bufs[0].shape) == (m, p)
        assert bufs[1].dtype == torch.float32
        assert bufs[1].numel() == ops.two_pass_scratch_floats(
            m, n, p, grid, instance)
        if instance == "stream":
            nseg = ops.round_stream_plan(m, n, grid)[2][-1]
            assert max(grid, m) <= nseg <= grid + m - 1
            assert bufs[1].numel() == nseg * p
            assert bufs[2].dtype == torch.int32
            assert bufs[2].numel() == 2 * grid + m + 2
        else:
            assert bufs[1].numel() == m * n


def test_cpu_calls_launch_nothing():
    """On CPU tensors both wrappers run their plain versions, in the stack,
    one-node and scalar-lambda forms, and move no launch count; the
    per-instance counts start from 0 with the others."""
    ops.two_pass_launches["stream"] += 2
    ops.reset_launches()
    assert ops.two_pass_launches == {"stream": 0, "direct": 0}
    t = _t(two_pass_problem(TWO_PASS_CASES[0]))
    args = (t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"], t["omega"])
    for dtype in (torch.float32, torch.bfloat16):
        got = ops.csvm_block_update(t["X"].to(dtype), *args[1:], t["lam"],
                                    h=H)
        assert torch.equal(got, cu.csvm_block_update_plain(
            t["X"].to(dtype), *args[1:], t["lam"], h=H))
    got = ops.csvm_local_update(*args, 0.01, h=H)
    assert torch.equal(got, cu.csvm_local_update_plain(*args, 0.01, h=H))
    one = ops.csvm_local_update(*(a[0] for a in args), t["lam"], h=H)
    torch.testing.assert_close(
        one, cu.csvm_local_update_plain(*args, t["lam"], h=H)[0], atol=ATOL,
        rtol=0)
    assert ops.launches == {k: 0 for k in ops.KERNELS}
    assert ops.two_pass_launches == {"stream": 0, "direct": 0}


def test_stream_launch_refuses_what_it_cannot_take():
    """Asked for by name, the stream instance refuses p > 8192 and a base
    off a 16-byte boundary before any launch, as does an unknown
    instance; the wrappers never ask for it there (the rule says
    direct)."""
    def operands(m, n, p, offset=0):
        flat = torch.zeros(offset + m * n * p)
        X = flat[offset:].view(m, n, p)
        rest = (torch.zeros(m, n), torch.zeros(m, p), torch.zeros(m, p),
                torch.zeros(m, p), torch.ones(m), torch.ones(m),
                torch.zeros(p))
        return (X,) + rest
    before = dict(ops.launches), dict(ops.two_pass_launches)
    args = operands(2, 3, 4, offset=1)
    assert args[0].data_ptr() % 16
    assert ops.two_pass_instance(2, 3, 4, x_ptr=args[0].data_ptr()) == \
        "direct"
    for name in ("csvm_block_update", "csvm_local_update"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops._two_pass_launch(name, *args, "stream", h=H)
        with pytest.raises(ValueError, match="p <= 8192"):
            ops._two_pass_launch(name, *operands(1, 1, 8193), "stream", h=H)
        with pytest.raises(ValueError, match="unknown instance"):
            ops._two_pass_launch(name, *operands(1, 2, 4), "fast", h=H)
    with pytest.raises(TypeError, match="X has dtype"):
        ops._two_pass_launch("csvm_local_update",
                             operands(1, 2, 4)[0].bfloat16(),
                             *operands(1, 2, 4)[1:], "stream", h=H)
    assert (dict(ops.launches), dict(ops.two_pass_launches)) == before


def test_chip_smoke_reads_the_update_stream_sass():
    """chip_smoke.py's reader of the bulk copies names the two-pass stream
    kernel beside the round kernel's stream instance, per dtype."""
    sass = ("\t\tFunction : _ZN12_GLOBAL__N_120update_stream_kernelIfEEvNS_4"
            "ArgsIT_EE\n"
            "        /*0100*/  UBLKCP.S.G [UR8], [UR4], UR6 ;\n"
            "\t\tFunction : _ZN12_GLOBAL__N_119round_stream_kernelI13__nv_"
            "bfloat16EEvNS_4ArgsIT_EE\n"
            "        /*0100*/  UBLKCP.S.G [UR8], [UR4], UR6 ;\n"
            "        /*0110*/  UBLKCP.S.G [UR8], [UR4], UR6 ;\n"
            "\t\tFunction : _ZN12_GLOBAL__N_120update_reduce_kernelEPKfPKiS1"
            "_S1_S1_S1_S1_S1_Pfii\n"
            "        /*0100*/  FADD R1, R2, R3 ;\n")
    assert chip_smoke.bulk_copy_counts(sass) == {
        "update_stream_kernel<float32>": (1, 0),
        "round_stream_kernel<bfloat16>": (2, 0)}


def test_profile_two_pass_refuses_to_run_without_a_card(monkeypatch):
    """The breakdown script is a card-only measurement: without a CUDA
    device it exits with a message, never timing the CPU."""
    from repro_torch.launch import profile_two_pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_two_pass.main(["--shape", "2", "3", "4"])
