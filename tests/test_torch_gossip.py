"""Torch port, gossip (``repro_torch.core.gossip``), mirroring
``tests/test_gossip.py`` and held against the JAX package's functions on
the same inputs: the Metropolis weights within 1e-7, gossip averages
within 1e-6, the same round bound, and the decentralized BIC per node
within 1e-5 with its exact value to 1e-6 (fp32 on both sides, sums in
another order).  Everything runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ADMMConfig, SimConfig, decsvm_fit, generate
from repro.core import gossip as jg
from repro.core.graph import erdos_renyi, metropolis_weights, ring
from repro_torch.core import gossip as tg
from _torch_cases import one_thread  # noqa: F401


@pytest.mark.parametrize("W", [erdos_renyi(10, 0.4, seed=5), ring(7),
                               erdos_renyi(8, 0.5, seed=0)])
def test_metropolis_weights_jnp_matches_jax_and_host(W):
    W32 = np.asarray(W, np.float32)
    got = tg.metropolis_weights_jnp(torch.tensor(W32)).numpy()
    want = np.asarray(jg.metropolis_weights_jnp(jnp.asarray(W32)))
    assert np.max(np.abs(got - want)) < 1e-7
    assert np.max(np.abs(got - metropolis_weights(np.asarray(W)))) < 1e-6
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("shape,rounds", [((8, 3), 200), ((8, 2, 3), 40),
                                          ((8,), 7)])
def test_gossip_average_matches_jax_and_converges(shape, rounds):
    W = erdos_renyi(8, 0.5, seed=0)
    v = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = tg.gossip_average(torch.tensor(v), W, rounds=rounds)
    want = np.asarray(jg.gossip_average(jnp.asarray(v), W, rounds=rounds))
    assert tuple(got.shape) == shape
    assert np.max(np.abs(got.numpy() - want)) < 1e-6
    if rounds == 200:
        assert np.max(np.abs(got.numpy() - v.mean(0)[None])) < 1e-5


@pytest.mark.parametrize("W,tol", [(ring(10), 1e-4), (ring(10), 1e-6),
                                   (erdos_renyi(8, 0.5, seed=0), 1e-6),
                                   (np.zeros((1, 1)), 1e-6)])
def test_gossip_rounds_needed_matches_jax(W, tol):
    assert tg.gossip_rounds_needed(W, tol) == jg.gossip_rounds_needed(W, tol)


def test_gossip_rounds_bound_is_sufficient():
    W = ring(10)
    r = tg.gossip_rounds_needed(W, tol=1e-4)
    v = torch.tensor(np.random.default_rng(1).standard_normal((10, 1)),
                     dtype=torch.float32)
    out = tg.gossip_average(v, W, rounds=r).numpy()
    assert np.ptp(out) < 1e-3 * max(float(np.ptp(v.numpy())), 1.0)


@pytest.mark.parametrize("rounds", [60, 300])
def test_decentralized_bic_matches_jax(rounds):
    cfg = SimConfig(p=30, s=5, m=6, n=80)
    X, y, _ = generate(cfg, seed=2)
    W = erdos_renyi(6, 0.6, seed=2)
    B = np.asarray(decsvm_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                              ADMMConfig(lam=0.05, max_iter=100)))
    per_node, exact = tg.decentralized_bic(X, y, B, W, rounds=rounds,
                                           device="cpu")
    jper, jexact = jg.decentralized_bic(X, y, jnp.asarray(B), W,
                                        rounds=rounds)
    assert isinstance(exact, float) and tuple(per_node.shape) == (6,)
    assert exact == pytest.approx(jexact, abs=1e-6)
    assert np.max(np.abs(per_node.numpy() - np.asarray(jper))) < 1e-5
    if rounds == 300:
        # every node converges to the same, correct criterion value
        assert np.max(np.abs(per_node.numpy() - exact)) < 1e-3 * max(
            abs(exact), 1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tg.decentralized_bic(X, y, B, W)
