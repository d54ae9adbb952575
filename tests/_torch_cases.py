"""Seeded inputs shared by the torch port's kernel tests (CPU and CUDA),
the plain model of the stream instances' order of arithmetic, and the
``one_thread`` fixture every port test module imports; no jax, so that
the CUDA tests run where jax is not installed."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while the importing module runs (``from
    _torch_cases import one_thread`` makes it autouse there): the port's
    test tensors are small, and under several test workers torch's
    per-process intra-op thread pools oversubscribe the cores (on an
    8-core CPU a test of 0.7 s alone took 30 s beside five other files
    under six workers); the old count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CountedBackward(torch.autograd.Function):
    """The identity, whose backward counts one flash backward launch."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.kernels import ops
        ops.launches["flash_attention_backward"] += 1
        return grad


def stand_in_counters(monkeypatch, backward=False):
    """For the CPU rehearsals of chip_smoke.py's phases (the CPU has no
    kernel): each wrapper call of a CSVM kernel, and each self- and
    cross-attention call of the model, counts as one launch; with
    ``backward``, so does the backward of each attention output that
    autograd differentiates (once an output of the pass under remat: the
    recomputed graph is not differentiated).  The counters start at 0.
    Returns ``repro_torch.kernels.ops``."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    for name in ("csvm_round_block", "csvm_block_update",
                 "csvm_local_update"):
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            ops.launches[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    for name in ("self_attend", "cross_attend"):
        def attend(q, k, v, _fn=getattr(attention, name), **kw):
            ops.launches["flash_attention"] += 1
            out = _fn(q, k, v, **kw)
            if backward and out.requires_grad:
                out = _CountedBackward.apply(out)
            return out
        monkeypatch.setattr(attention, name, attend)
    ops.reset_launches()
    return ops


def problem(m, n, p, seed=0, scale_b=0.05):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n, p)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], (m, n)).astype(np.float32)
    W = np.triu((rng.random((m, m)) < 0.6).astype(np.float32), 1)
    W = W + W.T
    deg = W.sum(1).astype(np.float32)
    rho = rng.uniform(1.0, 3.0, m).astype(np.float32) * (p / 8)
    omega = (1.0 / (2.0 * deg + rho + 0.1)).astype(np.float32)
    B = (rng.standard_normal((m, p)) * scale_b).astype(np.float32)
    P = (rng.standard_normal((m, p)) * 0.01).astype(np.float32)
    lam = rng.uniform(0.002, 0.02, p).astype(np.float32)
    neigh = (1.0 * (deg[:, None] * B + W @ B)).astype(np.float32)
    return dict(X=X, y=y, W=W, deg=deg, rho=rho, omega=omega, B=B, P=P,
                lam=lam, neigh=neigh)


# (m, n, p, num_rounds, nact, want_kkt, lam0, lam_vector, kernel):
# m not a multiple of 8 and n not a multiple of 16 (the JAX wrapper pads
# both), held rounds, nact = 0, lambda vectors and lam0 > 0.  The last two
# give the stream instance of the CUDA round kernel block ranges that cross
# node boundaries at its own grid (6 blocks of 30 rows over 45-row nodes;
# 5 over 50-row nodes), one with rows a multiple of 16 bytes (p = 24), one
# ragged (p = 13).
ROUND_CASES = [
    (5, 13, 37, 3, 3, False, 0.0, False, "epanechnikov"),
    (5, 13, 37, 4, 2, True, 0.1, True, "epanechnikov"),
    (3, 20, 9, 4, 0, False, 0.0, True, "gaussian"),
    (3, 20, 9, 3, 0, True, 0.2, False, "laplacian"),
    (6, 17, 130, 5, 5, True, 0.0, True, "logistic"),
    (4, 45, 24, 3, 3, True, 0.05, True, "epanechnikov"),
    (3, 50, 13, 4, 3, False, 0.0, True, "uniform"),
]


# (m, n, p, kernel, lam_vector, pad_rows) of the two-pass update: ragged p
# (37, 301, 13, 130), a p whose rows are a multiple of 16 bytes (24), m*n
# rows that cross node boundaries at the stream instance's grids (an H100's
# for (4, 45, 24): 6 blocks of 30 rows), the last pad_rows rows of each node
# padded with y = 0, every smoothing kernel.
TWO_PASS_CASES = [
    (5, 13, 37, "epanechnikov", True, 0),
    (3, 20, 301, "laplacian", False, 0),
    (4, 45, 24, "gaussian", True, 0),
    (3, 50, 13, "uniform", False, 4),
    (6, 17, 130, "logistic", True, 0),
]


def two_pass_problem(case, seed=None):
    """The seeded operands of a TWO_PASS_CASES entry (numpy): lam a (p,)
    vector, or one level repeated when the case takes a scalar lambda."""
    m, n, p, _, lam_vector, pad = case
    d = problem(m, n, p, seed=m + n + p if seed is None else seed)
    if pad:
        d["y"][:, n - pad:] = 0.0
    if not lam_vector:
        d["lam"] = np.full(p, 0.01, np.float32)
    return d


def segments(rows, n):
    """(node, first row, end row) of each node segment of a stream plan's
    row ranges, in segment order."""
    segs = []
    for a, b in zip(rows, rows[1:]):
        r = a
        while r < b:
            e = min(b, (r // n + 1) * n)
            segs.append((r // n, r, e))
            r = e
    return segs


def stream_x_pass(X, y, bsrc, scale, segs, kernel, h):
    """One X pass of the stream instances in plain torch: per node segment,
    the margins at round(b_l), w = round(L_h'(y m) y scale) and the
    segment's partial X^T w row (fp32 sums, bf16 X's dot operands rounded
    to bf16).  Returns the partial rows in segment order."""
    from repro_torch.core import losses
    from repro_torch.kernels import csvm_update as cu
    kern = losses.get_kernel(kernel)
    rnd = cu._rounder(X.dtype)
    m, n, p = X.shape
    Xf = X.to(torch.float32).reshape(m * n, p)
    yf = y.reshape(-1)
    parts = []
    for l, r0, r1 in segs:
        xs, ys = Xf[r0:r1], yf[r0:r1]
        w = rnd(kern.dloss(ys * (xs @ rnd(bsrc[l])), h) * ys * scale)
        parts.append(xs.T @ w)
    return parts


def sum_in_order(parts, p):
    """The partial rows summed one after another from zero."""
    g = torch.zeros(p)
    for part in parts:
        g = g + part
    return g
