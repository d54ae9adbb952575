"""The benchmark's frozen copies (``bench/frozen/``) agree with the port as
it stands, so that drift shows here while the benchmark never reads the
port's copies."""
import numpy as np
import pytest
import torch

from frozen import cost, data
from systems import decsvm_inputs as inputs
from repro_torch.core import graph, losses, simulate, tuning
from repro_torch.kernels import cost as port_cost
from repro_torch.launch import ranks

SIM = simulate.SimConfig(p=47, s=5, m=3, n=40, rho=0.5)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_device_problem_is_the_ports(seed):
    X, y = data.device_problem(SIM, seed, "cpu")
    Xp, yp = ranks.device_problem(SIM, seed, "cpu")
    assert torch.equal(X, Xp) and torch.equal(y, yp)


def test_a_block_of_one_is_device_problem(monkeypatch):
    full = simulate.SimConfig(p=4095, s=10, m=16, n=1024, rho=0.5)
    assert data.block_size(full) == 1
    monkeypatch.setattr(data, "BLOCK_BYTES", 1)
    seed = 2 ** 33 + 1
    Xs, ys = data.draw_pool(SIM, seed, 2, "cpu")
    for s, X, y in zip(data.dataset_seeds(seed, 2), Xs, ys):
        Xp, yp = ranks.device_problem(SIM, s, "cpu")
        assert torch.equal(X, Xp) and torch.equal(y, yp)


def test_a_block_draws_the_same_law():
    """A block of many datasets draws each of the law's parts as
    ``device_problem`` does, for all of them at once: its first dataset's
    labels are the port's first labels."""
    seed = 5
    assert data.block_size(SIM) > 40
    Xs, ys = data.draw_pool(SIM, seed, 40, "cpu")
    s0 = data.dataset_seeds(seed, 1)[0]
    X0, y0 = ranks.device_problem(SIM, s0, "cpu")
    assert torch.equal(Xs[0][..., 0], X0[..., 0])
    X = torch.stack(Xs).double()
    assert abs(float(X[..., 1:6].mean())) < 0.05
    assert float(X[..., 6:].std()) == pytest.approx(1.0, abs=0.02)


def test_laws_helpers_are_the_ports():
    assert np.array_equal(data.ar_cov(9, 0.5), simulate.ar_cov(9, 0.5))
    for seed in (0, 3, 2 ** 45):
        assert np.array_equal(data.erdos_renyi(16, 0.5, seed=seed),
                              graph.erdos_renyi(16, 0.5, seed=seed))
    for N, p in ((16384, 4095), (1200, 200), (10, 3)):
        assert data.default_bandwidth(N, p) == losses.default_bandwidth(N, p)
    assert np.array_equal(data.log_grid(0.7, 12, 1e-3),
                          tuning._log_grid(0.7, 12, 1e-3))


def test_grid_is_the_ports_shared_grid():
    pool = inputs.make_pool(dict(m=3, n=40, p=47, s=5, mu=0.4, ar_rho=0.5,
                                 p_flip=0.01, p_connect=0.5, grid_points=12,
                                 grid_min_frac=1e-3),
                            {"pool": 3}, 11, "cpu")
    Xs = torch.stack(pool.X).numpy()
    ys = torch.stack(pool.y).numpy()
    ours = inputs.grid_fp32(pool.grid)
    port = np.asarray(tuning.shared_lambda_grid(Xs, ys, num=12), np.float32)
    np.testing.assert_allclose(ours, port, rtol=1e-6)


@pytest.mark.parametrize("shape", [(16, 1024, 4096), (6, 200, 201),
                                   (10, 200, 101)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_work_is_the_ports(shape, itemsize):
    for rounds, kkt in ((300, False), (4, True), (1, False)):
        assert cost.round_block_work(*shape, itemsize, rounds, kkt) == \
            port_cost.round_block_work(*shape, itemsize, rounds, kkt)
    assert cost.two_pass_work(*shape, itemsize) == \
        port_cost.two_pass_work(*shape, itemsize)


def test_peaks_are_the_ports():
    assert cost.PEAK_FP32 == port_cost.PEAK_FP32
    assert cost.PEAK_BYTES == port_cost.PEAK_BYTES


def test_round_block_bound_is_perf_records():
    """PERF.md's bound of the 300-round launch at full size: 1.2019 ms,
    operations at the fp32 peak."""
    flops, nbytes = cost.round_block_work(16, 1024, 4096, 4, 300, False)
    assert round(cost.least_seconds(flops, nbytes) * 1e3, 4) == 1.2019
    assert flops / cost.PEAK_FP32 > nbytes / cost.PEAK_BYTES
