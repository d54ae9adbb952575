"""The benchmark's yardstick of work: frozen copies of the port's counts.

``round_block_work`` and ``two_pass_work`` are copies of
``repro_torch.kernels.cost``'s (the operations and bytes of the function
a kernel computes, each input read once and each output written once),
with ``ops.round_block_bytes`` less its scratch written out; the peaks
are its H100 SXM data-sheet peaks.  ``fit_work`` is the work of one
tuned fit, which depends on no kernel's name or instance.
``bench/tests/test_bench_frozen.py`` shows that the copies agree with the
port.
"""
from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, at its 700 W power limit): fp32
# outside the tensor cores, and device-memory bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time one card could take: the larger of the operations
    at the fp32 peak and the bytes at the memory peak."""
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def round_block_work(m, n, p, itemsize, num_rounds, want_kkt):
    """One ``csvm_round_block`` launch of ``num_rounds`` rounds: 4 flops an
    element of X a round (the margins and X^T w), and once more for the
    KKT epilogue; X in the compute dtype and y, B, P, W, deg, rho, omega,
    lam and the active count read once, B, P and the statistic written
    once."""
    f = 4
    operands = (m * n * p * itemsize + m * n * f + 2 * m * p * f
                + m * m * f + 3 * m * f + p * f + 4)
    outputs = 2 * m * p * f + f
    passes = num_rounds + (1 if want_kkt else 0)
    return 4 * m * n * p * passes, operands + outputs


def two_pass_work(m, n, p, itemsize):
    """One two-pass update (``csvm_block_update``): 4 flops an element of
    X; X read once (itemsize), y, B, P, the neighbour term, rho, omega and
    lam read and B+ written once (fp32)."""
    f = 4
    nbytes = (m * n * p * itemsize + m * n * f + 3 * m * p * f + 2 * m * f
              + p * f + m * p * f)
    return 4 * m * n * p, nbytes


def fit_work(m, n, p, grid_points, rounds, itemsize=4):
    """One tuned fit of the batched path: ``grid_points`` x ``rounds``
    rounds of 4 flops an element of X, and X, y and W read once."""
    flops = 4 * m * n * p * grid_points * rounds
    nbytes = m * n * p * itemsize + m * n * 4 + m * m * 4
    return flops, nbytes
