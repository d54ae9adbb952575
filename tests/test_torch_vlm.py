"""Torch port, the VLM on the CPU: internvl2-1b reduced (2 layers, d_model
256, GQA 4 over 2, attention biases, tied embeddings, a 16-position media
prefix), against the JAX package on the same numpy inputs and
JAX-initialised weights — ``forward`` behind a media prefix (logits of the
text positions only), prefill and decode as the text LM the serving
engine runs, the engine against JAX's lockstep ``greedy_generate``, and
the head's features; and chip_smoke.py's phase 13 rehearsed at the
reduced size.
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
from repro.optim import decsvm_head as jhead
import repro_torch.configs as tconfigs
from repro_torch.models import convert, model
from repro_torch.models.prefill import prefill
from repro_torch.optim import decsvm_head as head
from repro_torch.serving import Request, ServeEngine
from _torch_cases import one_thread, stand_in_counters  # noqa: F401

# fp32: the same fp32 arithmetic summed in another order (XLA on the CPU
# vs torch), the tier of tests/test_prefill.py.
ATOL = 5e-5
ARCH = "internvl2_1b"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jp = jmodel.init_params(jcfg, KEY)
    return jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _media(cfg, rows, seed):
    return np.random.default_rng(seed).standard_normal(
        (rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def test_forward_with_media_matches_jax(pair):
    """The media prefix goes in front of the token embeddings; the logits
    cover the text positions only; the prefix moves them."""
    jcfg, jp, tcfg, tp = pair
    toks, media = _tokens(jcfg, (2, 11), 1), _media(jcfg, 2, 2)
    jl, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks),
                                "media": jnp.asarray(media)}, jcfg)
    tl, aux = model.forward(tp, {"tokens": toks, "media": media}, tcfg)
    assert tuple(tl.shape) == (2, 11, jcfg.padded_vocab) and float(aux) == 0
    _close(tl, jl)
    text, _ = model.forward(tp, {"tokens": toks}, tcfg)
    assert float((text - tl).abs().max()) > 1e-3
    x, _ = model.hidden(tp, {"tokens": toks, "media": media}, tcfg)
    assert tuple(x.shape) == (2, 11, jcfg.d_model)


def test_prefill_and_decode_match_jax(pair):
    """The text LM the engine serves: prefill logits, the seeded cache and
    decode steps from it (a scalar, then a per-slot position)."""
    jcfg, jp, tcfg, tp = pair
    S, new = 13, 4
    toks = _tokens(jcfg, (2, S + new), 3)
    jl, jc, _ = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, 24)
    tl, tc, pos = prefill(tp, {"tokens": toks[:, :S]}, tcfg, 24)
    assert pos == S
    _close(tl, jl)
    got = convert.cache_to_numpy(tc)["layers"]
    for name, want in jc["layers"].items():
        np.testing.assert_allclose(got[name], np.asarray(want), atol=ATOL,
                                   rtol=0)
    for t in range(S, S + new):
        p = np.int32(t) if t < S + 2 else np.array([t, t], np.int32)
        jd, jc = jmodel.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                    jnp.asarray(p), jcfg)
        td, tc = model.decode_step(tp, tc, toks[:, t], torch.as_tensor(p),
                                   tcfg)
        _close(td, jd)


@pytest.mark.parametrize("block_prefill", [False, True])
def test_engine_matches_jax_greedy_generate(pair, block_prefill):
    """Three requests over two slots (one slot reused) against JAX's
    lockstep ``greedy_generate`` of each prompt."""
    jcfg, jp, tcfg, tp = pair
    prompts = _tokens(jcfg, (3, 9), 4)
    want = np.asarray(jserve.greedy_generate(jcfg, jp, jnp.asarray(prompts),
                                             max_new=5))[:, 9:]
    eng = ServeEngine(tcfg, tp, max_batch=2, max_len=32,
                      block_prefill=block_prefill, device="cpu")
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt.tolist(), max_new=5))
    done = eng.run()
    assert {r: q.generated for r, q in done.items()} == {
        r: want[r].tolist() for r in range(3)}


def test_features_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(jcfg, (5, 10), 5)
    want = jhead.extract_features(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  batch_size=2)
    got = head.extract_features(tp, tcfg, toks, batch_size=2)
    assert got.shape == (5, jcfg.d_model)
    _close(got, want)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model.init_params(cfg, device="cpu"))


def test_chip_smoke_vlm_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 13 at the reduced size: the engine with block
    prefill (one launch a layer and request), the kernel against the plain
    attention in the model, and the forward pass behind the media prefix
    (one launch a layer, the text positions' logits), both with their
    controls at the fp32 limit."""
    import chip_smoke
    from repro_torch.serving import engine
    ops = stand_in_counters(monkeypatch)
    cfg = tconfigs.get_reduced(ARCH)
    params = model.init_params(cfg, seed=0, device="cpu")
    served = chip_smoke.backbone_serving(torch, ops, engine, cfg, params,
                                         prompts=(20, 9, 5), max_len=40,
                                         instance="wgmma")
    assert served["launches"]["flash_attention"] == 3 * cfg.num_layers
    tol, controls = chip_smoke.MODEL_TOL["float32"], {}
    dev, _ = chip_smoke.in_model_instances(torch, ops, cfg, params,
                                           label="tiny", instance="wgmma",
                                           prompt=30, tol=tol,
                                           controls=controls)
    assert dev == 0.0 and controls["tiny"] > tol
    out = chip_smoke.media_forward(torch, ops, cfg, params, text=7, tol=tol,
                                   control=True)
    assert out["launches"] == cfg.num_layers and out["max_abs_dev"] == 0.0
    assert out["control_dev"] > tol
    assert out["prefix_moves"] > 0.0
