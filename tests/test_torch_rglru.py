"""Torch port, the RG-LRU hybrid (recurrentgemma) on the CPU: the gates and
the log-depth scan (with and without a carried state, S up to 96), the
Griffin block forward and its one-token decode, against the JAX package on
the same numpy inputs and JAX-initialised weights; and the hybrid stack as
a whole — the mixed cache layout (pattern stacks and a tail layer) and its
carrier, block prefill with a prompt longer than the window (the ring
cache wraps), decode, ``ServeEngine``'s tokens against JAX's greedy
decode, and a reused slot that must not inherit the previous request's
conv history or state.

The reduced config has pattern (rec, attn) and 2 layers; ``num_layers=5``
gives 2 repeats of the pattern and a tail ``rec`` layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.launch import serve as jserve
from repro.models.prefill import prefill as jprefill
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro_torch.models import convert, model, rglru
from repro_torch.models.prefill import prefill
from repro_torch.serving import Request, ServeEngine
from _torch_cases import one_thread, stand_in_counters  # noqa: F401

# fp32: the tier of tests/test_prefill.py
ATOL = 5e-5
KEY = jax.random.PRNGKey(0)
ARCH = "recurrentgemma_2b"
# JAX's functions compiled, as its engine runs its step (run op by op,
# the reference prefill of a 96-token prompt takes ~10 s on an 8-core CPU)
jprefill = jax.jit(jprefill, static_argnums=(2, 3))
jdecode = jax.jit(jmodel.decode_step, static_argnums=(4,))
jforward = jax.jit(jmodel.forward, static_argnums=(2,))
jscan = jax.jit(jrglru.rglru_scan)
jblock = jax.jit(jrglru.rglru_block_forward, static_argnums=(2,))
jblock_decode = jax.jit(jrglru.rglru_block_decode, static_argnums=(3,))


@pytest.fixture(scope="module")
def block():
    """(JAX config, JAX RG-LRU params, port config, port block) on the
    same weights."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jp = jrglru.init_rglru_block(KEY, jcfg, jnp.float32)
    tp = rglru.init_rglru_block(tcfg, torch.float32,
                                torch.Generator().manual_seed(0))
    for name, value in jp.items():
        getattr(tp, name).data = convert.to_tensor(value, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=[2, 5])
def pair(request):
    """(JAX config, JAX params, port config, port model) of the reduced
    hybrid with 2 layers (one pattern) or 5 (two and a tail layer)."""
    jcfg = jconfigs.get_reduced(ARCH, num_layers=request.param)
    tcfg = tconfigs.get_reduced(ARCH, num_layers=request.param)
    jp = jmodel.init_params(jcfg, KEY)
    return jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("S", [1, 33, 96])
@pytest.mark.parametrize("carried", [False, True])
def test_gates_and_scan_match_jax(block, S, carried):
    jcfg, jp, tcfg, tp = block
    x = _x((2, S, jcfg.lru_width), seed=S)
    h0 = _x((2, jcfg.lru_width), seed=7) if carried else None
    jla, jb = jrglru._gates(jp, jnp.asarray(x))
    tla, tb = rglru._gates(tp, torch.from_numpy(x))
    _close(tla, jla, atol=1e-6)
    _close(tb, jb, atol=1e-6)
    jh, jlast = jscan(jp, jnp.asarray(x),
                      None if h0 is None else jnp.asarray(h0))
    th, tlast = rglru.rglru_scan(
        tp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    _close(th, jh)
    _close(tlast, jlast)


def test_linear_scan_matches_the_recurrence():
    """The Hillis-Steele scan against the step-by-step recurrence."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (2, 96, 8)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 96, 8)).astype(np.float32))
    a_s, h = rglru.linear_scan(a, b)
    ht, prod = torch.zeros(2, 8), torch.ones(2, 8)
    for t in range(96):
        ht = a[:, t] * ht + b[:, t]
        prod = prod * a[:, t]
        assert float((h[:, t] - ht).abs().max()) < 1e-5, t
        assert float((a_s[:, t] - prod).abs().max()) < 1e-6, t


def test_block_forward_and_decode_match_jax(block):
    """The Griffin block over 12 tokens, then the same tokens one at a time
    through the decode step (tests/test_models.py::
    test_rglru_decode_matches_forward), against JAX and each other."""
    jcfg, jp, tcfg, tp = block
    x = _x((1, 12, jcfg.d_model), seed=2, scale=0.3)
    jfull = jblock(jp, jnp.asarray(x), jcfg)
    tfull = rglru.rglru_block_forward(tp, torch.from_numpy(x), tcfg)
    _close(tfull, jfull)
    jc = jrglru.init_rglru_cache(jcfg, 1, jnp.float32)
    tc = rglru.init_rglru_cache(tcfg, 1, torch.float32, "cpu")
    for t in range(12):
        jo, jc = jblock_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        to, tc = rglru.rglru_block_decode(tp, torch.from_numpy(
            x[:, t:t + 1]), tc, tcfg)
        _close(to, jo)
        _close(to, tfull[:, t:t + 1].numpy())
        for name in jc:
            _close(tc[name], jc[name])


def test_forward_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 20))
    jl, _ = jforward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    tl, aux = model.forward(tp, {"tokens": toks}, tcfg)
    assert float(aux) == 0.0
    _close(tl, jl)


def test_cache_layout_and_carrier_round_trip(pair):
    """``init_cache`` keeps JAX's mixed layout (names, shapes, dtypes);
    ``cache_from_jax`` and ``cache_to_numpy`` carry it both ways; a decode
    step from a carried JAX cache matches JAX's."""
    jcfg, jp, tcfg, tp = pair
    want = jmodel.init_cache(jcfg, 2, 16)
    got = model.init_cache(tcfg, 2, 16, device="cpu")
    assert "layers" not in got and sorted(got) == sorted(want)
    assert len(got["tail_layers"]) == jcfg.num_layers % 2
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        convert.cache_to_numpy(got))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, j), (_, t) in zip(jflat, tflat):
        assert j.shape == t.shape
        assert (j.dtype == jnp.float32) == (t.dtype == np.float32)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 10))
    _, jc, _ = jprefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                        16)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    back = convert.cache_to_numpy(tc)
    for (_, j), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jc)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(t, np.asarray(j))
    pos = np.array([10, 7], np.int32)
    jd, _ = jdecode(jp, jc, jnp.asarray(toks[:, -1]),
                               jnp.asarray(pos), jcfg)
    td, _ = model.decode_step(tp, tc, toks[:, -1], torch.from_numpy(pos),
                              tcfg)
    _close(td, jd)


def test_prefill_ring_wrap_matches_jax(pair):
    """tests/test_prefill.py::test_prefill_ring_wrap: a 96-token prompt
    over the window of 64, so the attention layers' ring caches wrap;
    prefill logits and the seeded cache against JAX's, then decode steps
    from it against JAX's and against the full forward."""
    jcfg, jp, tcfg, tp = pair
    S, new = 96, 4
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size,
                                             (1, S + new)).astype(np.int32)
    full, _ = model.forward(tp, {"tokens": toks}, tcfg)
    jl, jc, _ = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                         S + new)
    tl, tc, pos = prefill(tp, {"tokens": toks[:, :S]}, tcfg, S + new)
    assert pos == S and tcfg.sliding_window == 64
    _close(tl, jl)
    got = jax.tree_util.tree_leaves(convert.cache_to_numpy(tc))
    for t, j in zip(got, jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(t, np.asarray(j), atol=ATOL)
    worst = float((tl[:, -1] - full[:, S - 1]).abs().max())
    for t in range(S, S + new):
        jd, jc = jdecode(jp, jc, jnp.asarray(toks[:, t]),
                                    jnp.asarray(t, jnp.int32), jcfg)
        td, tc = model.decode_step(tp, tc, toks[:, t], t, tcfg)
        _close(td, jd)
        worst = max(worst, float((td - full[:, t]).abs().max()))
    assert worst < ATOL, worst


def _greedy(jcfg, jp, prompts, max_new=4):
    """JAX's tokens for equal-length prompts in one lockstep batch
    (``repro.launch.serve.greedy_generate``).  JAX's ``ServeEngine`` is no
    reference for a hybrid: its slot reset and prefill splice pick leaves
    by a leading axis of num_layers or max_batch, so they skip a pattern
    stack (n_rep, B, ...), or zero a repeat of it for every slot when
    n_rep == max_batch (ROADMAP, caveats about the reference)."""
    out = jserve.greedy_generate(jcfg, jp, jnp.asarray(prompts, jnp.int32),
                                 max_new=max_new)
    return np.asarray(out)[:, len(prompts[0]):].tolist()


def _engine(tcfg, tp, prompts, *, max_batch, block_prefill, logits=None):
    """The port's tokens for ``prompts``; every decode step's logits are
    appended to ``logits`` when a list is given."""
    eng = ServeEngine(tcfg, tp, max_batch=max_batch, max_len=64,
                      block_prefill=block_prefill, device="cpu")
    if logits is not None:
        decode = eng._decode

        def recorded(toks, pos):
            out, cache = decode(toks, pos)
            logits.append(out.clone())
            return out, cache
        eng._decode = recorded
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4))
    done = eng.run()
    assert sorted(done) == list(range(len(prompts)))
    return [done[r].generated for r in range(len(prompts))]


def test_engine_tokens_match_jax(pair):
    """tests/test_serving.py::test_engine_completes_requests on the port:
    five requests over two slots (three admitted into reused slots), with
    block prefill on and off, give JAX's greedy tokens."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, 6).tolist()
               for _ in range(5)]
    want = _greedy(jcfg, jp, prompts)
    for block_prefill in (False, True):
        assert _engine(tcfg, tp, prompts, max_batch=2,
                       block_prefill=block_prefill) == want


def test_reused_slot_does_not_inherit_state(pair):
    """tests/test_serving.py::
    test_engine_continuous_batching_is_isolation_safe on the hybrid: a
    request admitted into a reused slot reproduces its solo run (the conv
    history and RG-LRU state of the previous occupant, in the pattern and
    tail stacks, must not leak), with and without block prefill, and both
    requests give JAX's greedy tokens."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, 8).tolist()
    first = rng.integers(0, jcfg.vocab_size, 12).tolist()
    want = [_greedy(jcfg, jp, [first])[0], _greedy(jcfg, jp, [prompt])[0]]
    for block_prefill in (False, True):
        solo_logits, reused_logits = [], []
        solo = _engine(tcfg, tp, [prompt], max_batch=1,
                       block_prefill=block_prefill, logits=solo_logits)
        got = _engine(tcfg, tp, [first, prompt], max_batch=1,
                      block_prefill=block_prefill, logits=reused_logits)
        assert got[1] == solo[0] == want[1]
        assert got[0] == want[0]
        # the reused slot's steps are the solo run's, logit for logit
        tail = reused_logits[-len(solo_logits):]
        assert max(float((a - b).abs().max())
                   for a, b in zip(tail, solo_logits)) < ATOL


def test_chip_smoke_recurrentgemma_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's recurrentgemma phase end to end on the CPU at a tiny
    size (the reduced hybrid with 5 layers, window 64): a prompt longer
    than the window through the engine with block prefill, the shortest
    again on one slot with and without block prefill (logits and tokens),
    the kernel against the plain attention inside
    the model (one launch per attention layer), the D = 256 attention and
    RG-LRU timings (a stand-in for CUDA events runs each function once;
    ``scaled_dot_product_attention`` timed causal where the window masks
    nothing, with a boolean window mask where it is active), and the head
    on its features."""
    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.serving import engine
    ops = stand_in_counters(monkeypatch)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda torch_, fn, reps, warmup=1: (fn(), 1.0)[1])
    cfg = tconfigs.get_reduced(ARCH, num_layers=5)
    params = model.init_params(cfg, seed=0, device="cpu")
    assert chip_smoke.kernel_layers(cfg) == 2
    served = chip_smoke.backbone_serving(torch, ops, engine, cfg, params,
                                         prompts=(70, 20, 9), max_len=90,
                                         instance="wgmma")
    assert served["launches"]["flash_attention"] == 3 * 2
    for tol in (None, 1e-4):
        agree = chip_smoke.tokenwise_agreement(
            torch, engine, cfg, params, served["prompts"][-1], max_len=90,
            tol=tol)
        assert agree["equal"] and agree["first_logits_dev"] < 1e-4
        assert agree["control_dev"] > 1e-4
    dev, _ = chip_smoke.in_model_instances(torch, ops, cfg, params,
                                           label="tiny", instance="wgmma",
                                           prompt=30)
    assert dev == 0.0
    # the window active (S > window, as the long prompt's prefill) and not
    for S, window in ((96, 64), (64, 64)):
        row = chip_smoke.flash_d256_timing(torch, ops, ref, "cpu", S=S,
                                           window=window)
        assert row["max_abs_dev"] == 0.0
        assert row["library_ms"] == 1.0
        assert row["library_how"] == ("a boolean window mask" if S > window
                                      else "causal")
    mask = chip_smoke.window_mask(torch, 5, 5, 2, "cpu")
    assert mask.tolist() == [[j <= i and j > i - 2 for j in range(5)]
                             for i in range(5)]
    assert chip_smoke.attention_pairs(96, 64) == sum(
        min(i + 1, 64) for i in range(96))
    # at the card's S = 2048 the causal attention's operations bound it
    assert chip_smoke.attention_bound(1, 10, 1, 2048, 256, 2)[1] == \
        "operations"
    assert chip_smoke.rglru_timing(torch, cfg, params, S=96)["rounds"] == 7
    out = chip_smoke.head_phase(torch, tcore, ops, cfg, params,
                                shape=(2, 8, 8), plain_seqs=0,
                                fits=("megakernel",),
                                admm=dict(lam=0.02, h=0.3, max_iter=20))
    assert out["flash_launches"] == 2
