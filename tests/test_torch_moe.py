"""Torch port, the MoE family (granite-moe) on the CPU: the fp32 router
(gates, expert indices, the Switch aux loss), both routes of the MoE mixer
— "dense" (every expert, masked combine) and "scatter" (capacity
dispatch, with drops at the default capacity factor) — against the JAX
package on the same numpy inputs and JAX-initialised weights; scatter
against dense where nothing drops; and, for both granite configs, block
prefill, decode and ``ServeEngine``'s tokens against JAX's.

The expert indices are compared exactly: ``torch.topk`` and
``lax.top_k`` could order exact ties of router probabilities differently,
and with random fp32 router logits no tie occurs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.prefill import prefill as jprefill
from repro.serving import Request as JRequest, ServeEngine as JServeEngine
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro_torch.models import convert, model, moe
from repro_torch.models.prefill import prefill
from repro_torch.serving import Request, ServeEngine
from _torch_cases import one_thread, stand_in_counters  # noqa: F401

# fp32: the tier of tests/test_prefill.py
ATOL = 5e-5
KEY = jax.random.PRNGKey(0)
GRANITE = ["granite_moe_1b_a400m", "granite_moe_3b_a800m"]
# JAX's prefill and decode step compiled, as its engine runs the step
jprefill = jax.jit(jprefill, static_argnums=(2, 3))
jdecode = jax.jit(jmodel.decode_step, static_argnums=(4,))


def _mixer(**over):
    """(JAX config, JAX MoE params, port config, port MoE) on the same
    weights, reduced granite-moe-1b (4 experts, top 2)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced("granite_moe_1b_a400m"),
                               **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced("granite_moe_1b_a400m"),
                               **over)
    jp = jmoe.init_moe(KEY, jcfg, jnp.float32)
    tp = moe.init_moe(tcfg, torch.float32, torch.Generator().manual_seed(0))
    for name, value in jp.items():
        getattr(tp, name).data = convert.to_tensor(value, "cpu")
    return jcfg, jp, tcfg, tp


def _x(shape, seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def test_route_matches_jax():
    jcfg, jp, tcfg, tp = _mixer()
    x2 = _x((40, jcfg.d_model), seed=1, scale=2.0)
    jg, ji, ja = jmoe._route(jp, jnp.asarray(x2), jcfg)
    tg, ti, ta = moe._route(tp, torch.from_numpy(x2), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, atol=1e-6)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-6)


def _correlated(shape, seed):
    """Tokens sharing one direction (as the tokens of one topic do) plus
    noise: the router sends most of them to the same experts."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, 1, shape[-1]))
    return (base + 0.5 * rng.standard_normal(shape)).astype(np.float32)


# 24 correlated tokens at capacity factor 1.25: C = 16 rows an expert for
# 48 assignments that go 23 / 20 / 0 / 5 to the 4 experts, so 11 drop (the
# scatter case asserts that some do)
@pytest.mark.parametrize("routing", ["dense", "scatter"])
def test_routes_match_jax(routing):
    jcfg, jp, tcfg, tp = _mixer(moe_routing=routing)
    x = _correlated((2, 12, jcfg.d_model), seed=3)
    jy, ja = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    ty, ta = moe.moe_forward(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    if routing == "scatter":
        _, idx, _ = moe._route(tp, torch.from_numpy(x).reshape(24, -1), tcfg)
        per_expert = torch.bincount(idx.reshape(-1), minlength=4)
        assert int(per_expert.max()) > moe.capacity(tcfg, 24) == 16
        dense, _ = moe.moe_forward_dense(tp, torch.from_numpy(x), tcfg)
        assert float((ty - dense).abs().max()) > 1e-3     # drops show


def test_scatter_matches_dense_with_ample_capacity():
    """tests/test_models.py::test_moe_scatter_matches_dense on the port."""
    _, _, tcfg, tp = _mixer(moe_capacity_factor=4.0)
    x = torch.from_numpy(_x((2, 16, tcfg.d_model), seed=3, scale=0.5))
    y_dense, aux_d = moe.moe_forward_dense(tp, x, tcfg)
    y_scat, aux_s = moe.moe_forward_scatter(tp, x, tcfg)
    np.testing.assert_allclose(y_dense.numpy(), y_scat.numpy(), atol=1e-5)
    assert float(aux_d) == pytest.approx(float(aux_s), abs=1e-6)
    assert 0.5 < float(aux_d) < 4.0
    again, _ = moe.moe_forward_scatter(tp, x, tcfg)
    assert torch.equal(again, y_scat)


def _scatter_grads(tp, tcfg, x, w):
    """d(sum(y * w) + aux)/d(x and each MoE weight) of the port's scatter
    route, by autograd."""
    for p in tp.parameters():
        p.requires_grad_(True)
        p.grad = None
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_forward_scatter(tp, xt, tcfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    grads = {name: p.grad for name, p in tp.named_parameters()}
    return dict(grads, x=xt.grad)


# the configured capacity factor (11 of 48 assignments drop, as in
# test_routes_match_jax) and one where nothing drops
@pytest.mark.parametrize("capacity_factor", [1.25, 2.0])
def test_scatter_route_gradients_match_jax(capacity_factor):
    """The scatter route under grad (the dispatch's gather and its
    index-sum backward, the combine over k): the gradients of sum(y * w) +
    aux with respect to x and every MoE weight against ``jax.grad`` of
    ``repro.models.moe.moe_forward`` (scatter) on the same weights and
    inputs, each within 2e-5 of its largest entry (fp32 summed in other
    orders); two runs equal bit for bit."""
    jcfg, jp, tcfg, tp = _mixer(moe_routing="scatter",
                                moe_capacity_factor=capacity_factor)
    x = _correlated((2, 12, jcfg.d_model), seed=3)
    w = _x(x.shape, seed=4, scale=1.0)

    def jloss(p, xx):
        y, aux = jmoe.moe_forward(p, xx, jcfg)
        return jnp.sum(y * w) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    want = dict(jgp, x=jgx)
    got = _scatter_grads(tp, tcfg, x, w)
    again = _scatter_grads(tp, tcfg, x, w)
    assert set(got) == set(want) == {"x", "router", "w_gate", "w_up",
                                     "w_down"}
    for name, g in got.items():
        ref_g = np.asarray(want[name])
        dev = np.abs(g.numpy() - ref_g).max()
        assert dev <= 2e-5 * np.abs(ref_g).max(), (name, dev)
        assert torch.equal(g, again[name]), name
    dropped = capacity_factor == 1.25
    _, idx, _ = moe._route(tp, torch.from_numpy(x).reshape(24, -1), tcfg)
    per_expert = torch.bincount(idx.reshape(-1), minlength=4)
    assert (int(per_expert.max()) > moe.capacity(tcfg, 24)) == dropped


@pytest.fixture(scope="module", params=GRANITE)
def granite(request):
    arch = request.param
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jmodel.init_params(jcfg, KEY)
    return jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


def test_prefill_and_decode_match_jax(granite):
    """Prefill logits and the seeded cache, then decode steps from it,
    against JAX; and the port's prefill-then-decode against its own pure
    decode (tests/test_prefill.py's invariant)."""
    jcfg, jp, tcfg, tp = granite
    S, B, new, max_len = 14, 2, 4, 24
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size,
                                              (B, S + new)).astype(np.int32)
    jl, jc, _ = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                         max_len)
    tl, tc, pos = prefill(tp, {"tokens": toks[:, :S]}, tcfg, max_len)
    assert pos == S
    _close(tl, jl)
    got = convert.cache_to_numpy(tc)["layers"]
    for name, want in jc["layers"].items():
        np.testing.assert_allclose(got[name], np.asarray(want), atol=ATOL)
    pure = model.init_cache(tcfg, B, max_len, device="cpu")
    for t in range(S):
        model.decode_step(tp, pure, toks[:, t], t, tcfg)
    for t in range(S, S + new):
        jd, jc = jdecode(jp, jc, jnp.asarray(toks[:, t]),
                                    jnp.asarray(t, jnp.int32), jcfg)
        td, tc = model.decode_step(tp, tc, toks[:, t], t, tcfg)
        ref, pure = model.decode_step(tp, pure, toks[:, t], t, tcfg)
        _close(td, jd)
        assert float((td - ref).abs().max()) < ATOL


def test_engine_tokens_match_jax(granite):
    """Three requests over two slots (one reused): the port's greedy
    tokens with block prefill on and off equal JAX's engine's (token by
    token; tests/test_prefill.py holds JAX's block prefill to it)."""
    jcfg, jp, tcfg, tp = granite
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (9, 5, 9)]
    jeng = JServeEngine(jcfg, jp, max_batch=2, max_len=32)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new=4))
    want = {r: q.generated for r, q in jeng.run().items()}
    for block_prefill in (False, True):
        teng = ServeEngine(tcfg, tp, max_batch=2, max_len=32,
                           block_prefill=block_prefill, device="cpu")
        for rid, prompt in enumerate(prompts):
            teng.submit(Request(rid=rid, prompt=prompt, max_new=4))
        got = {r: q.generated for r, q in teng.run().items()}
        assert got == want and sorted(got) == [0, 1, 2]


def test_chip_smoke_granite_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's granite-moe phase end to end on the CPU at a tiny
    size (reduced granite-moe-3b): the engine with block prefill, two
    prompts again on one slot with and without it (the same tokens), the
    kernel against the plain attention inside the model,
    the MoE route checks, and the head on its features."""
    import chip_smoke
    from repro_torch.serving import engine
    ops = stand_in_counters(monkeypatch)
    cfg = tconfigs.get_reduced("granite_moe_3b_a800m")
    params = model.init_params(cfg, seed=0, device="cpu")
    served = chip_smoke.backbone_serving(torch, ops, engine, cfg, params,
                                         prompts=(20, 9, 5, 3), max_len=40,
                                         instance="wgmma")
    assert served["launches"]["flash_attention"] == 4 * cfg.num_layers
    for prompt in served["prompts"][-2:]:
        agree = chip_smoke.tokenwise_agreement(torch, engine, cfg, params,
                                               prompt, max_len=40)
        assert agree["equal"] and agree["first_logits_dev"] < 1e-4
    dev, _ = chip_smoke.in_model_instances(torch, ops, cfg, params,
                                           label="tiny", instance="wgmma",
                                           prompt=30)
    assert dev == 0.0
    routes = chip_smoke.moe_route_checks(torch, cfg, params, tokens=30)
    # C = int(1.25 x 30 x 2 / 4) + 1
    assert routes["deterministic"] and routes["capacity"] == 19
    assert routes["layer_dev"] <= 1e-5 * routes["layer_scale"]
    out = chip_smoke.head_phase(torch, tcore, ops, cfg, params,
                                shape=(2, 8, 8), plain_seqs=0,
                                fits=("megakernel",),
                                admm=dict(lam=0.02, h=0.3, max_iter=20))
    assert out["fit_launches"]["csvm_round_block"] == 1
    assert out["flash_launches"] == cfg.num_layers
