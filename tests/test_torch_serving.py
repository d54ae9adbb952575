"""Torch port, the serving slice as a whole on the CPU: block prefill (logits
and the seeded cache) and decode against the JAX package on JAX-initialised
weights, the port's prefill-then-decode against its pure decode, and
``ServeEngine`` / ``greedy_generate`` tokens against JAX's, with and without
block prefill and across reused slots; plus a rehearsal of
``chip_smoke.py``'s serving phases at a tiny size.  The dense families and
mamba2-370m (whose seeded cache is the conv history and the SSM state).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models.prefill import prefill as jprefill
from repro.serving import Request as JRequest, ServeEngine as JServeEngine
import repro_torch.configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, convert, model
from repro_torch.models.prefill import _ring_fill, prefill
from repro_torch.serving import Request, ServeEngine
from _torch_cases import one_thread  # noqa: F401

# fp32: the tier of tests/test_prefill.py
ATOL = 5e-5
DENSE = ["qwen3_14b", "qwen3_32b", "glm4_9b", "command_r_35b"]
# the families the port serves (tests/test_prefill.py:16 and
# tests/test_serving.py:74 cover mamba2)
SERVED = DENSE + ["mamba2_370m"]
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", params=SERVED)
def pair(request):
    arch = request.param
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jmodel.init_params(jcfg, KEY)
    return arch, jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _tokens(n, vocab, seed, batch=None):
    rng = np.random.default_rng(seed)
    shape = (batch, n) if batch else (n,)
    return rng.integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("S,cache_len", [(5, 8), (8, 8), (13, 8)])
def test_ring_fill_places_the_latest_positions(S, cache_len):
    kv = torch.arange(2 * S * 3 * 2, dtype=torch.float32).reshape(2, S, 3, 2)
    ring = _ring_fill(kv, cache_len)
    assert ring.shape == (2, cache_len, 3, 2)
    for s in range(cache_len):
        p = S - 1 - ((S - 1 - s) % cache_len)
        want = kv[:, p] if 0 <= p < S else torch.zeros(2, 3, 2)
        assert torch.equal(ring[:, s], want)


def test_prefill_and_decode_match_jax(pair):
    """Prefill logits, the seeded cache (every layer) and the next_pos,
    then decode steps from that cache, against JAX on the same weights."""
    arch, jcfg, jp, tcfg, tp = pair
    S, B, new, max_len = 14, 2, 4, 24
    toks = _tokens(S + new, jcfg.vocab_size, seed=11, batch=B)
    jl, jc, jpos = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                            max_len)
    tl, tc, tpos = prefill(tp, {"tokens": toks[:, :S]}, tcfg, max_len)
    assert int(jpos) == tpos == S
    _close(tl, jl)
    got = convert.cache_to_numpy(tc)["layers"]
    for name, want in jc["layers"].items():
        assert got[name].shape == want.shape
        np.testing.assert_allclose(got[name], np.asarray(want), atol=ATOL)
    for t in range(S, S + new):
        jd, jc = jmodel.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                    jnp.asarray(t, jnp.int32), jcfg)
        td, tc = model.decode_step(tp, tc, toks[:, t], t, tcfg)
        _close(td, jd)


def test_decode_from_a_jax_cache_matches_jax(pair):
    """cache_from_jax carries a JAX decode cache over; vector positions."""
    arch, jcfg, jp, tcfg, tp = pair
    B, S = 2, 10
    toks = _tokens(S, jcfg.vocab_size, seed=12, batch=B)
    _, jc, _ = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 16)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    pos = np.array([S, S - 3], np.int32)
    tok = toks[:, -1]
    jd, _ = jmodel.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                               jcfg)
    td, _ = model.decode_step(tp, tc, tok, torch.from_numpy(pos), tcfg)
    _close(td, jd)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_then_decode_matches_pure_decode(arch):
    """The port against itself (tests/test_prefill.py's invariant)."""
    cfg = tconfigs.get_reduced(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    S, B, new = 16, 2, 6
    toks = _tokens(S + new, cfg.vocab_size, seed=7, batch=B)
    cache = model.init_cache(cfg, B, S + new, device="cpu")
    ref = []
    for t in range(S + new):
        lg, cache = model.decode_step(params, cache, toks[:, t], t, cfg)
        ref.append(lg.clone())
    lg_pf, cache, pos = prefill(params, {"tokens": toks[:, :S]}, cfg,
                                S + new)
    assert pos == S
    worst = float((lg_pf[:, -1] - ref[S - 1]).abs().max())
    for t in range(S, S + new):
        lg, cache = model.decode_step(params, cache, toks[:, t], t, cfg)
        worst = max(worst, float((lg - ref[t]).abs().max()))
    assert worst < ATOL, worst


def _run_engines(jcfg, jp, tcfg, tp, prompts, *, max_batch, block_prefill,
                 max_new=5, max_len=64):
    jeng = JServeEngine(jcfg, jp, max_batch=max_batch, max_len=max_len,
                        block_prefill=block_prefill)
    teng = ServeEngine(tcfg, tp, max_batch=max_batch, max_len=max_len,
                       block_prefill=block_prefill, device="cpu")
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=list(prompt), max_new=max_new))
        teng.submit(Request(rid=rid, prompt=list(prompt), max_new=max_new))
    jdone, tdone = jeng.run(), teng.run()
    assert sorted(jdone) == sorted(tdone) == list(range(len(prompts)))
    return ({r: q.generated for r, q in jdone.items()},
            {r: q.generated for r, q in tdone.items()})


@pytest.mark.parametrize("arch", ["qwen3_14b", "command_r_35b",
                                  "mamba2_370m"])
def test_engine_tokens_match_jax_with_and_without_block_prefill(arch):
    """tests/test_prefill.py::test_engine_block_prefill_matches_tokenwise,
    held against JAX's engine: the same greedy tokens from the port with
    block prefill on and off."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jmodel.init_params(jcfg, KEY)
    tp = convert.params_from_jax(jp, tcfg, "cpu")
    prompt = _tokens(10, jcfg.vocab_size, seed=3)
    want, slow = _run_engines(jcfg, jp, tcfg, tp, [prompt], max_batch=1,
                              block_prefill=False)
    _, fast = _run_engines(jcfg, jp, tcfg, tp, [prompt], max_batch=1,
                           block_prefill=True)
    assert slow[0] == fast[0] == want[0]
    assert len(fast[0]) == 5


def test_engine_continuous_batching_matches_jax():
    """Five requests of uneven prompts over two slots (slots reused,
    staggered positions), block prefill on: the port's tokens equal JAX's,
    and a request in a reused slot reproduces its solo run (tests/
    test_serving.py's isolation invariant).  Two prompt lengths besides
    the one-token prompt keep JAX's eager prefill compiles few."""
    jcfg, tcfg = (jconfigs.get_reduced("qwen3_14b"),
                  tconfigs.get_reduced("qwen3_14b"))
    jp = jmodel.init_params(jcfg, KEY)
    tp = convert.params_from_jax(jp, tcfg, "cpu")
    prompts = [_tokens(n, jcfg.vocab_size, seed=i)
               for i, n in enumerate((10, 4, 10, 1, 4))]
    want, got = _run_engines(jcfg, jp, tcfg, tp, prompts, max_batch=2,
                             block_prefill=True, max_new=4)
    assert got == want
    solo = ServeEngine(tcfg, tp, max_batch=1, max_len=64,
                       block_prefill=True, device="cpu")
    solo.submit(Request(rid=0, prompt=list(prompts[2]), max_new=4))
    assert solo.run()[0].generated == got[2]


def test_mamba2_reused_slot_does_not_inherit_state():
    """tests/test_serving.py::test_engine_continuous_batching_is_isolation_safe
    on the port, with and without block prefill: a request admitted into
    a reused slot reproduces its solo run (the carried SSM state and conv
    history of the previous occupant must not leak), and the tokens equal
    JAX's engine's."""
    jcfg, tcfg = (jconfigs.get_reduced("mamba2_370m"),
                  tconfigs.get_reduced("mamba2_370m"))
    jp = jmodel.init_params(jcfg, KEY)
    tp = convert.params_from_jax(jp, tcfg, "cpu")
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, 8).tolist()
    first = rng.integers(0, jcfg.vocab_size, 12).tolist()
    for block_prefill in (False, True):
        solo = ServeEngine(tcfg, tp, max_batch=1, max_len=64,
                           block_prefill=block_prefill, device="cpu")
        solo.submit(Request(rid=0, prompt=prompt, max_new=5))
        want = solo.run()[0].generated
        want_j, got = _run_engines(jcfg, jp, tcfg, tp, [first, prompt],
                                   max_batch=1, block_prefill=block_prefill)
        assert got[1] == want == want_j[1]
        assert got[0] == want_j[0]


def test_greedy_generate_and_serve_step_match_jax():
    jcfg, tcfg = (jconfigs.get_reduced("qwen3_14b"),
                  tconfigs.get_reduced("qwen3_14b"))
    jp = jmodel.init_params(jcfg, KEY)
    tp = convert.params_from_jax(jp, tcfg, "cpu")
    prompt = _tokens(6, jcfg.vocab_size, seed=4, batch=3)
    want = np.asarray(jserve.greedy_generate(jcfg, jp, jnp.asarray(prompt),
                                             max_new=6))
    got = serve.greedy_generate(tcfg, tp, prompt, max_new=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cache = model.init_cache(tcfg, 3, 8, device="cpu")
    nxt, logits, cache = serve.make_serve_step(tcfg)(tp, cache, prompt[:, 0],
                                                     0)
    assert torch.equal(nxt, torch.argmax(logits, -1).to(torch.int32))


def test_engine_defaults_to_cuda_and_prefill_refuses_int8():
    cfg = tconfigs.get_reduced("qwen3_14b")
    params = model.init_params(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params)
    import dataclasses
    q8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        prefill(params, {"tokens": np.zeros((1, 4), np.int32)}, q8, 8)


def test_chip_smoke_serving_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's flash checks, serving run and kernel-vs-plain model
    check run end to end on the CPU at a tiny size.  The CPU has no
    kernel: ``ops.flash_attention`` runs its plain version, and a stand-in
    for ``attention.self_attend`` feeds the launch counter so that the
    count checks (one launch per layer and prefilled request) run too."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FLASH_CASES",
                        chip_smoke.FLASH_CASES[:2]
                        + [(1, 40, 8, 70, 16, True, None)])
    devs = {}
    chip_smoke.flash_checks(torch, ops, __import__(
        "repro_torch.kernels.ref", fromlist=["mha"]), "cpu", devs)
    assert set(devs["flash_attention"]) == {"float32", "bfloat16"}

    plain = attention.self_attend

    def counted(q, k, v, **kw):
        ops.launches["flash_attention"] += 1
        return plain(q, k, v, **kw)
    monkeypatch.setattr(attention, "self_attend", counted)
    from repro_torch.serving import engine
    cfg = tconfigs.get_reduced("qwen3_14b")
    params = model.init_params(cfg, seed=0, device="cpu")
    out = chip_smoke.serving_path(torch, ops, engine, cfg, params,
                                  prompts=(20, 15, 9, 4, 2), max_new=3,
                                  max_batch=2, max_len=32)
    assert out["launches"]["flash_attention"] == 5 * cfg.num_layers
    assert [S for S, _ in out["prefill_ms"]] == [19, 14, 8, 3, 1]
    dev, scale = chip_smoke.kernel_vs_plain_in_model(
        torch, ops, cfg, params, label="tiny", tol=1e-5, prompt=30)
    assert dev == 0.0 and scale > 0


def test_chip_smoke_mamba2_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's ssd_scan checks, mamba2 serving run and
    kernel-vs-plain model check end to end on the CPU at a tiny size.  The
    CPU has no kernel: ``ops.ssd_scan`` runs its plain version, and a
    stand-in for ``ssm.ssd`` that runs the wrapper feeds the launch
    counter, so that the count checks (one launch per layer and prefilled
    request, no flash_attention) run too."""
    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.models import ssm

    monkeypatch.setattr(chip_smoke, "SSD_CASES",
                        chip_smoke.SSD_CASES[:2]
                        + [(1, 77, 32, 64, 128, 64)])
    devs = {}
    chip_smoke.ssd_checks(torch, ops, ref, "cpu", devs)
    assert set(devs["ssd_scan"]) == {"float32", "bfloat16"}
    assert devs["ssd_scan"]["float32"] == 0.0   # the wrapper is ref here

    def counted(x, dt, A, B, C, D, cfg):
        ops.launches["ssd_scan"] += 1
        return ops.ssd_scan(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)
    monkeypatch.setattr(ssm, "ssd", counted)
    from repro_torch.serving import engine
    cfg = tconfigs.get_reduced("mamba2_370m")
    params = model.init_params(cfg, seed=0, device="cpu")
    out = chip_smoke.serving_path(torch, ops, engine, cfg, params,
                                  prompts=(20, 15, 9, 4, 2), max_new=3,
                                  max_batch=2, max_len=32, kernel="ssd_scan")
    assert out["launches"]["ssd_scan"] == 5 * cfg.num_layers
    assert out["launches"]["flash_attention"] == 0
    assert [S for S, _ in out["prefill_ms"]] == [19, 14, 8, 3, 1]
    dev, scale, sdev = chip_smoke.ssd_vs_plain_in_model(
        torch, ops, cfg, params, label="tiny", tol=1e-5, prompt=37)
    assert dev == 0.0 and sdev == 0.0 and scale > 0
    for S in (2048, 1023):
        bms, by = chip_smoke.ssd_bound(1, S, 32, 64, 128, 64, 2)
        assert by == "bytes"
    # at S = 2048: 3.76 GFLOP and 19.1 MB, a 5.7 us bound set by the bytes
    assert chip_smoke.ssd_bound(1, 2048, 32, 64, 128, 64, 2)[0] == \
        pytest.approx(5.70e-3, rel=0.01)
