"""Torch port, the encoder-decoder stack on the CPU: seamless-m4t-large-v2
reduced (2 encoder + 2 decoder layers, d_model 256, 32 frames), each part
against the JAX package on the same numpy inputs and JAX-initialised
weights — learned positions, the encoder, cross-attention (full-sequence
and one-token), the blocks with cross-attention, ``forward`` with
``enc_media``, ``build_cross_cache``, ``init_cache``'s layout,
``decode_step`` from a cross cache, ``prefill`` (logits and the whole
cache), prefill then decode against pure decode, the head's features, and
the cache carrier; ``ref.mha`` and the flash wrapper with keys of their own
length against JAX's ``attention._attend``, and their refusal of a mask
there; the serving entry points' refusal; and chip_smoke.py's phase 14 and
cross checks rehearsed at the reduced size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.prefill import prefill as jprefill
from repro.optim import decsvm_head as jhead
import repro_torch.configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import greedy_generate
from repro_torch.models import attention, blocks, convert, model
from repro_torch.models.prefill import prefill
from repro_torch.optim import decsvm_head as head
from repro_torch.serving import ServeEngine
from _torch_cases import one_thread, stand_in_counters  # noqa: F401

# fp32 forward, prefill and decode: the same fp32 arithmetic summed in
# another order (XLA on the CPU vs torch), the tier of tests/test_prefill.py;
# one layer or block: 1e-5; ref.mha against JAX's _attend: 1e-6.
ATOL = 5e-5
ATOL_LAYER = 1e-5
ATOL_MHA = 1e-6
ARCH = "seamless_m4t_large_v2"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port model) on the same
    weights."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jp = jmodel.init_params(jcfg, KEY)
    return jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(cfg, B=2, S=12, seed=1):
    """Tokens (B, S) and frames (B, frontend_len, d_model)."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return {"tokens": toks,
            "enc_media": _randn(B, cfg.frontend_len, cfg.d_model, seed=seed)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _layer(tree, i=0):
    return jax.tree.map(lambda t: t[i], tree)


# (B, H, KV, Sq, Sk, D): one query, fewer and more keys than queries, MQA
MHA_CASES = [(1, 4, 4, 1, 32, 16), (2, 4, 2, 37, 20, 32),
             (1, 8, 1, 9, 70, 64)]


@pytest.mark.parametrize("case", MHA_CASES)
def test_mha_with_keys_of_their_own_length_matches_jax(case):
    """ref.mha and the wrapper on CPU tensors (no launch) with Sk != Sq,
    non-causal, against JAX's model attention ``_attend`` over positions
    0..Sq-1 and 0..Sk-1."""
    B, H, KV, Sq, Sk, D = case
    q, k, v = (_randn(B, H, Sq, D, seed=1), _randn(B, KV, Sk, D, seed=2),
               _randn(B, KV, Sk, D, seed=3))
    want = np.asarray(jattention._attend(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
        jnp.arange(Sq), jnp.arange(Sk), causal=False,
        window=None)).transpose(0, 2, 1, 3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = dict(ops.launches)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    assert ops.launches == before
    assert torch.equal(got, ref.mha(tq, tk, tv, causal=False))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_MHA, rtol=0)


def test_operand_check_needs_the_mask():
    """The operand check's key-length rule depends on the mask, so every
    caller names it: ``causal`` is a required keyword."""
    q, k = torch.zeros(1, 4, 6, 16), torch.zeros(1, 2, 6, 16)
    with pytest.raises(TypeError, match="causal"):
        ops._check_attention(q, k, k, None)


@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=False, window=4)])
def test_keys_of_their_own_length_refuse_a_mask(mask):
    """A causal or windowed call with Sk != Sq raises ValueError in the
    plain version, in the wrapper on the CPU and in the card's operand
    check; with Sk == Sq both masks stay allowed."""
    q, k = torch.zeros(1, 4, 6, 16), torch.zeros(1, 2, 9, 16)
    for call in (lambda: ref.mha(q, k, k, **mask),
                 lambda: ops.flash_attention(q, k, k, **mask),
                 lambda: ops._check_attention(q, k, k, mask.get("window"),
                                              causal=mask["causal"])):
        with pytest.raises(ValueError, match="keys of their own length"):
            call()
    same = torch.zeros(1, 2, 6, 16)
    assert ref.mha(q, same, same, **mask).shape == q.shape
    ops._check_attention(q, same, same, mask.get("window"),
                         causal=mask["causal"])


def test_cross_attention_matches_jax(pair):
    """Layer 0's cross-attention: the full-sequence form over an encoder
    output (no RoPE, no mask, Sk != Sq) and the one-token form against a
    fixed cross K/V, which leaves the cache as it is."""
    jcfg, jp, tcfg, tp = pair
    jc, tc = _layer(jp["layers"])["cross"], tp.layers[0].cross
    assert not hasattr(tc, "q_norm")
    x, enc = _randn(2, 11, jcfg.d_model, seed=4), _randn(2, 32, jcfg.d_model,
                                                         seed=5)
    _close(attention.attention_forward(tc, torch.from_numpy(x), tcfg,
                                       causal=False,
                                       kv_x=torch.from_numpy(enc)),
           jattention.attention_forward(jc, jnp.asarray(x), jcfg,
                                        causal=False, kv_x=jnp.asarray(enc)),
           ATOL_LAYER)
    kv = {"k": _randn(2, 32, jcfg.num_kv_heads, jcfg.head_dim, seed=6),
          "v": _randn(2, 32, jcfg.num_kv_heads, jcfg.head_dim, seed=7)}
    x1 = _randn(2, 1, jcfg.d_model, seed=8)
    sentinel = {"k": torch.zeros(1)}
    got, cache = attention.attention_decode(
        tc, torch.from_numpy(x1), sentinel, 5, tcfg,
        cross_kv={n: torch.from_numpy(a) for n, a in kv.items()})
    want, _ = jattention.attention_decode(
        jc, jnp.asarray(x1), None, jnp.asarray(5, jnp.int32), jcfg,
        cross_kv={n: jnp.asarray(a) for n, a in kv.items()})
    assert cache is sentinel and torch.equal(sentinel["k"], torch.zeros(1))
    _close(got, want, ATOL_LAYER)


def test_blocks_match_jax(pair):
    """A decoder block with cross-attention over an encoder output, its
    one-token step against a cross K/V, and an encoder block
    (non-causal)."""
    jcfg, jp, tcfg, tp = pair
    jl, tl = _layer(jp["layers"], 1), tp.layers[1]
    x, enc = _randn(2, 9, jcfg.d_model, seed=9), _randn(2, 32, jcfg.d_model,
                                                        seed=10)
    jy, _ = jblocks.block_forward(jl, jnp.asarray(x), jcfg, "attn",
                                  enc_out=jnp.asarray(enc))
    ty, _ = blocks.block_forward(tl, torch.from_numpy(x), tcfg, "attn",
                                 enc_out=torch.from_numpy(enc))
    _close(ty, jy, ATOL_LAYER)
    je, te = _layer(jp["enc_layers"]), tp.enc_layers[0]
    assert not hasattr(te, "cross")
    jy, _ = jblocks.block_forward(je, jnp.asarray(x), jcfg, "attn",
                                  causal=False)
    ty, _ = blocks.block_forward(te, torch.from_numpy(x), tcfg, "attn",
                                 causal=False)
    _close(ty, jy, ATOL_LAYER)
    B, F, KV, D = 2, 32, jcfg.num_kv_heads, jcfg.head_dim
    kv = {"k": _randn(B, F, KV, D, seed=11), "v": _randn(B, F, KV, D,
                                                         seed=12)}
    x1 = _randn(B, 1, jcfg.d_model, seed=13)
    jcache = jattention.init_kv_cache(jcfg, B, 8, jnp.float32)
    tcache = attention.init_kv_cache(tcfg, B, 8, torch.float32, "cpu")
    jy, jcache = jblocks.block_decode(
        jl, jnp.asarray(x1), jcache, jnp.asarray(3, jnp.int32), jcfg, "attn",
        cross_kv={n: jnp.asarray(a) for n, a in kv.items()})
    ty, tcache = blocks.block_decode(
        tl, torch.from_numpy(x1), tcache, 3, tcfg, "attn",
        cross_kv={n: torch.from_numpy(a) for n, a in kv.items()})
    _close(ty, jy, ATOL_LAYER)
    for name in jcache:
        _close(tcache[name], jcache[name], ATOL_LAYER)


def test_learned_positions_and_encoder_match_jax(pair):
    """Token embeddings plus learned positions, and the encoder stack with
    its final norm (``model.encode``)."""
    jcfg, jp, tcfg, tp = pair
    batch = _batch(jcfg)
    _close(model._embed_tokens(tp, torch.from_numpy(batch["tokens"]), tcfg),
           jmodel._embed_tokens(jp, jnp.asarray(batch["tokens"]), jcfg),
           ATOL_LAYER)
    jenc, _ = jmodel._scan_stack(jp["enc_layers"],
                                 jnp.asarray(batch["enc_media"]), jcfg,
                                 "attn", causal=False, window=None,
                                 remat=False)
    jenc = jlayers.apply_norm(jenc, jp["enc_norm"], jcfg.norm)
    _close(model.encode(tp, batch["enc_media"], tcfg), jenc)


def test_forward_with_enc_media_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    batch = _batch(jcfg, S=20)
    jl, _ = jmodel.forward(jp, _jax(batch), jcfg)
    tl, aux = model.forward(tp, batch, tcfg)
    assert tuple(tl.shape) == (2, 20, jcfg.padded_vocab) and float(aux) == 0
    _close(tl, jl)


def test_build_cross_cache_and_init_cache_match_jax(pair):
    """build_cross_cache's (L, B, F, KV, D) K/V, and init_cache's layout
    (names, shapes, dtypes; cross_kv of frontend_len frames, zeros) with
    cross_kv's slot axis named in ``cache_leaves``."""
    jcfg, jp, tcfg, tp = pair
    batch = _batch(jcfg)
    want = jmodel.build_cross_cache(jp, jnp.asarray(batch["enc_media"]),
                                    jcfg)
    got = model.build_cross_cache(tp, batch["enc_media"], tcfg)
    assert set(got) == {"k", "v"}
    for name in want:
        assert tuple(got[name].shape) == want[name].shape == (
            jcfg.num_layers, 2, 32, jcfg.num_kv_heads, jcfg.head_dim)
        _close(got[name], want[name])
    jcache = jmodel.init_cache(jcfg, 3, 10)
    tcache = model.init_cache(tcfg, 3, 10, device="cpu")
    flat = convert.cache_to_numpy(tcache)
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tflat = jax.tree_util.tree_flatten_with_path(flat)[0]
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (_, a), (_, b) in zip(tflat, jflat):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()
    axes = {id(t): axis for t, axis in model.cache_leaves(tcache)}
    for name in ("k", "v"):
        assert axes[id(tcache["cross_kv"][name])] == 1


def test_decode_from_a_cross_cache_matches_jax(pair):
    """Token-by-token decode from JAX's cross cache carried into the
    port (``cache_from_jax``), a scalar then a per-slot position: logits
    and the whole cache after every step."""
    jcfg, jp, tcfg, tp = pair
    batch = _batch(jcfg, S=6)
    jcache = jmodel.init_cache(jcfg, 2, 8)
    jcache["cross_kv"] = jmodel.build_cross_cache(
        jp, jnp.asarray(batch["enc_media"]), jcfg)
    tcache = convert.cache_from_jax(jcache, "cpu")
    for t in range(6):
        pos = np.int32(t) if t < 3 else np.array([t, t - 2], np.int32)
        tok = batch["tokens"][:, t]
        jl, jcache = jmodel.decode_step(jp, jcache, jnp.asarray(tok),
                                        jnp.asarray(pos), jcfg)
        tl, tcache = model.decode_step(tp, tcache, tok, torch.as_tensor(pos),
                                       tcfg)
        _close(tl, jl)
    got, want = convert.cache_to_numpy(tcache), jcache
    for group in ("layers", "cross_kv"):
        for name in want[group]:
            _close(torch.from_numpy(got[group][name]), want[group][name])


def test_prefill_matches_jax(pair):
    """Prefill logits and the whole seeded cache, cross_kv included."""
    jcfg, jp, tcfg, tp = pair
    batch = _batch(jcfg, S=14)
    jl, jcache, jpos = jprefill(jp, _jax(batch), jcfg, 20)
    tl, tcache, pos = prefill(tp, batch, tcfg, 20)
    assert pos == int(jpos) == 14
    _close(tl, jl)
    got = convert.cache_to_numpy(tcache)
    assert set(got) == set(jcache) == {"layers", "cross_kv"}
    for group in got:
        assert set(got[group]) == set(jcache[group])
        for name in got[group]:
            np.testing.assert_allclose(got[group][name],
                                       np.asarray(jcache[group][name]),
                                       atol=ATOL, rtol=0)


def test_prefill_then_decode_matches_pure_decode(pair):
    """tests/test_prefill.py's check on the port: prefill of 16 tokens and
    6 decode steps against 22 decode steps from ``build_cross_cache``."""
    _, _, tcfg, tp = pair
    S, new = 16, 6
    batch = _batch(tcfg, S=S + new, seed=7)
    toks = batch["tokens"]
    cache = model.init_cache(tcfg, 2, S + new, device="cpu")
    cache["cross_kv"] = model.build_cross_cache(tp, batch["enc_media"], tcfg)
    ref_logits = []
    for t in range(S + new):
        lg, cache = model.decode_step(tp, cache, toks[:, t], t, tcfg)
        ref_logits.append(lg)
    lg_pf, cache, pos = prefill(tp, {"tokens": toks[:, :S],
                                     "enc_media": batch["enc_media"]},
                                tcfg, S + new)
    assert pos == S
    worst = float((lg_pf[:, -1] - ref_logits[S - 1]).abs().max())
    for t in range(S, S + new):
        lg, cache = model.decode_step(tp, cache, toks[:, t], t, tcfg)
        worst = max(worst, float((lg - ref_logits[t]).abs().max()))
    assert worst < ATOL, worst


def test_features_match_jax(pair):
    """The head's trunk: the decoder stack alone over the tokens, with
    learned positions and no encoder or cross-attention, as the
    reference's."""
    jcfg, jp, tcfg, tp = pair
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (5, 10))
    want = jhead.extract_features(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  batch_size=2)
    got = head.extract_features(tp, tcfg, toks, batch_size=2)
    assert got.shape == (5, jcfg.d_model)
    _close(got, want)


def test_serving_entry_points_refuse_the_encoder_decoder(pair):
    """A request carries no encoder input, and the JAX package's engine
    and greedy_generate decode against a zeroed cross_kv: the port's
    raise instead."""
    _, _, tcfg, tp = pair
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServeEngine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        greedy_generate(tcfg, tp, np.zeros((1, 4), np.int64), max_new=2)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 8)
    assert "cross_kv" in model.init_cache(cfg, 1, 8, device="cpu")


def test_chip_smoke_cross_checks_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's cross checks (every case on the plain version here,
    the causal path cases, and the refusal of a masked call with Sk != Sq)
    at small shapes."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "CROSS_CASES",
                        [(1, 4, 4, 1, 70, 64), (1, 4, 4, 9, 70, 64),
                         (2, 4, 2, 33, 20, 128)])
    monkeypatch.setattr(chip_smoke, "ENCODER_CASE", (1, 4, 4, 40, 40, 64))
    monkeypatch.setattr(chip_smoke, "CAUSAL_PATH_CASES",
                        [("decoder", (2, 4, 4, 30, 64)),
                         ("served", (1, 4, 2, 29, 64))])
    devs = {}
    chip_smoke.cross_checks(torch, ops, ref, "cpu", devs)
    assert devs["flash_attention"] == {"float32": 0.0, "bfloat16": 0.0}
    assert chip_smoke.attention_bound(2, 4, 2, 33, 64, 2, Sk=20,
                                      causal=False) == \
        chip_smoke.bound(4 * 2 * 4 * 64 * 33 * 20,
                         (2 * 2 * 4 * 33 + 2 * 2 * 2 * 20) * 64 * 2,
                         chip_smoke.PEAK_BF16)


def test_chip_smoke_encdec_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 14 at the reduced size: two lockstep batches
    (their launches by path: encoder, decoder, cross, one per layer), the
    kernel against the plain attention on the three paths (the same plain
    attention here), and block prefill against token-wise decode (the
    fp32 limit of the copy, with its control; the in-model check at the
    fp32 limit, with its control)."""
    import chip_smoke
    ops_ = stand_in_counters(monkeypatch)
    for name in ("ENCDEC_TOKENWISE_TOL", "ENCDEC_MODEL_TOL"):
        monkeypatch.setattr(chip_smoke, name,
                            chip_smoke.MODEL_TOL["float32"])
    cfg = tconfigs.get_reduced(ARCH)
    params = model.init_params(cfg, seed=0, device="cpu")
    out = chip_smoke.encdec_phase(torch, ops_, cfg, params,
                                  prompts=((12, 12), (7,)))
    L, E = cfg.num_layers, cfg.num_encoder_layers
    for run, B in zip(out["runs"], (2, 1)):
        assert run["launches_by_path"] == {"encoder": E, "decoder": L,
                                           "cross": L}
        assert run["launches"] == E + 2 * L and run["B"] == B
        assert np.array(run["tokens"]).shape == (B, chip_smoke.ENCDEC_NEW)
        assert len(run["decode_ms"]) == chip_smoke.ENCDEC_NEW - 1
    assert out["in_model"][0] == 0.0
    assert out["in_model_control"] > chip_smoke.MODEL_TOL["float32"]
    (record,) = out["tokenwise"]
    assert record["first_logits_dev"] <= chip_smoke.MODEL_TOL["float32"]
    assert record["block"] == record["tokenwise"]
    assert record["control_dev"] > record["tol"]
    short, media = out["short"]
    assert len(short) == 7 and tuple(media.shape) == (1, 32, cfg.d_model)
