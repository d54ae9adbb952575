"""Torch port, losses: the five smoothed hinges against the JAX package,
and autograd against the closed forms (including the Laplacian kink)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro_torch.core import losses as tl
from _torch_cases import one_thread  # noqa: F401

# fp32 elementwise formulas evaluated by two libraries (different exp /
# erf implementations): a few ulps of values of order 1.
ATOL = 2e-6

# grid across every regime of z = (1 - v)/h: both tails, the kink v = 1,
# and the edges |z| = 1 of the compact kernels
V = np.concatenate([np.linspace(-3.0, 3.0, 61),
                    [1.0, 1.0 - 0.25, 1.0 + 0.25, 0.999, 1.001]]
                   ).astype(np.float32)


@pytest.mark.parametrize("kernel", tl.KERNELS)
@pytest.mark.parametrize("fn", ["loss", "dloss", "ddloss"])
def test_loss_functions_match_jax(kernel, fn):
    for h in (0.25, 0.7):
        want = np.asarray(getattr(jl.get_kernel(kernel), fn)(jnp.asarray(V), h))
        got = getattr(tl.get_kernel(kernel), fn)(torch.tensor(V), h).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", tl.KERNELS)
def test_lipschitz_and_helpers_match_jax(kernel):
    # rel 1e-7: the JAX package takes 1/sqrt(2 pi) for the Gaussian c_h
    # from an fp32 sqrt; the port keeps the double constant
    for h in (0.1, 0.25, 1.3):
        assert tl.get_kernel(kernel).lipschitz(h) == pytest.approx(
            jl.get_kernel(kernel).lipschitz(h), rel=1e-7)
    np.testing.assert_allclose(
        tl.smoothed_hinge_loss(torch.tensor(V), 0.3, kernel).numpy(),
        np.asarray(jl.smoothed_hinge_loss(jnp.asarray(V), 0.3, kernel)),
        atol=ATOL)
    np.testing.assert_allclose(
        tl.smoothed_hinge_grad(torch.tensor(V), 0.3, kernel).numpy(),
        np.asarray(jl.smoothed_hinge_grad(jnp.asarray(V), 0.3, kernel)),
        atol=ATOL)


def test_hinge_and_bandwidth_match_jax():
    np.testing.assert_array_equal(tl.hinge(torch.tensor(V)).numpy(),
                                  np.asarray(jl.hinge(jnp.asarray(V))))
    for n, p in [(2000, 101), (16384, 4096), (3, 1), (10**7, 5)]:
        assert tl.default_bandwidth(n, p) == jl.default_bandwidth(n, p)


@pytest.mark.parametrize("kernel", tl.KERNELS)
def test_autograd_of_loss_is_dloss(kernel):
    """d loss / dv by autograd equals the closed-form dloss everywhere,
    kink included — the Laplacian routes its gradient through the closed
    form (an ``autograd.Function``), as JAX's ``custom_jvp`` does."""
    k = tl.get_kernel(kernel)
    v = torch.tensor(V, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(k.loss(v, 0.25).sum(), v)
    np.testing.assert_allclose(g.numpy(), k.dloss(v.detach(), 0.25).numpy(),
                               atol=1e-12)
    # and equals JAX's own gradient of its loss, except exactly on the
    # edges |z| = 1 of the compact kernels, where JAX's autodiff of the
    # clip picks another subgradient than the closed form (a reference
    # caveat; the closed-form check above covers those points)
    jg = np.asarray(jax.vmap(jax.grad(
        lambda x: jl.get_kernel(kernel).loss(x, 0.25)))(jnp.asarray(V)))
    edge = np.abs(np.abs((1.0 - V.astype(np.float64)) / 0.25) - 1.0) < 1e-6
    if kernel not in ("uniform", "epanechnikov"):
        edge[:] = False
    np.testing.assert_allclose(g.numpy()[~edge], jg[~edge], atol=ATOL)


def test_laplacian_kink_gradient_exact():
    k = tl.get_kernel("laplacian")
    v = torch.ones(3, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(k.loss(v, 0.4).sum(), v)
    assert torch.equal(g, k.dloss(torch.ones(3), 0.4))
    assert float(g[0]) == pytest.approx(-0.5)


@pytest.mark.parametrize("kernel", tl.KERNELS)
def test_autograd_of_dloss_is_ddloss_off_kinks(kernel):
    """Curvature: autograd of dloss equals ddloss away from the points
    where it jumps (v = 1 for the Laplacian, |z| = 1 for the compact
    kernels)."""
    k = tl.get_kernel(kernel)
    h = 0.5
    z = (1.0 - V.astype(np.float64)) / h
    keep = (np.abs(np.abs(z) - 1.0) > 1e-3) & (np.abs(z) > 1e-3)
    v = torch.tensor(V[keep], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(k.dloss(v, h).sum(), v)
    np.testing.assert_allclose(g.numpy(), k.ddloss(v.detach(), h).numpy(),
                               atol=1e-10)


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        tl.get_kernel("cauchy")
