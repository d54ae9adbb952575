"""Torch port, the dense LM stack on the CPU: layers, MLP, attention
(projections, full-sequence, one-token decode with the ring cache, vector
positions, the int8 cache and a window), the forward pass and the weight
carrier, each against the JAX package on the same numpy inputs and
JAX-initialised weights.  Reduced configs of the four dense families the
port serves: qwen3-14b, qwen3-32b, glm4-9b (partial RoPE, biases) and
command-r-35b (layernorm, tied embeddings); the forward pass, the blocks
and the weight carrier also for the SSM family, mamba2-370m (its mixer:
``test_torch_ssm.py``), the MoE family, granite-moe-1b-a400m
(``test_torch_moe.py``), the RG-LRU hybrid, recurrentgemma-2b (its
pattern stacks; ``test_torch_rglru.py``), the VLM, internvl2-1b
(``test_torch_vlm.py``), and the encoder-decoder, seamless-m4t-large-v2
(its encoder stack and cross-attention; ``test_torch_encdec.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as jmodel
import repro_torch.configs as tconfigs
from repro_torch.models import attention, blocks, convert, layers, mlp, model
from _torch_cases import one_thread  # noqa: F401

# fp32: the same fp32 arithmetic summed in another order (XLA on the CPU
# vs torch) — the tier of tests/test_prefill.py.
ATOL = 5e-5
DENSE = ["qwen3_14b", "qwen3_32b", "glm4_9b", "command_r_35b"]
KEY = jax.random.PRNGKey(0)


# the families the port runs (tests/test_prefill.py:16 covers mamba2,
# granite-moe, recurrentgemma and seamless-m4t)
SERVED = DENSE + ["mamba2_370m", "granite_moe_1b_a400m", "recurrentgemma_2b",
                  "internvl2_1b", "seamless_m4t_large_v2"]


def _pair(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jmodel.init_params(jcfg, KEY)
    return arch, jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(arch, JAX config, JAX params, port config, port model) on the same
    weights: the dense families (attention tests)."""
    return _pair(request.param)


@pytest.fixture(scope="module", params=SERVED)
def any_pair(request):
    """As ``pair``, over every family the port serves."""
    return _pair(request.param)


def _layer0(jp):
    """Layer 0 of a JAX tree: the first of its stack, or of a hybrid's
    first pattern stack."""
    stack = jp["layers"] if "layers" in jp else jp["pattern_layers"][0]
    return jax.tree.map(lambda t: t[0], stack)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_registry_is_a_copy(arch):
    for get in ("get", "get_reduced"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.padded_vocab == t.padded_vocab
    assert tconfigs.get("qwen3-14b", num_layers=2).num_layers == 2
    assert tconfigs.get("qwen3_14b").padded_vocab == 152064


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "internvl2_1b"])
def test_media_and_encdec_families_build_as_jax(arch):
    """The VLM and the encoder-decoder build on the CPU with the JAX
    tree's parameters (names, shapes, dtypes; learned positions, the
    encoder stack and the cross-attention of the encoder-decoder) and the
    JAX decode cache's layout (cross_kv included)."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    lm = model.init_params(tcfg, device="cpu")
    carried = convert.params_from_jax(jmodel.init_params(jcfg, KEY), tcfg,
                                      "cpu")
    shapes = {n: (p.shape, p.dtype) for n, p in lm.named_parameters()}
    assert shapes == {n: (p.shape, p.dtype)
                      for n, p in carried.named_parameters()}
    assert any(n.startswith("enc_layers.") for n in shapes) == \
        (arch == "seamless_m4t_large_v2")
    jc = jax.tree_util.tree_flatten_with_path(jmodel.init_cache(jcfg, 2, 8))
    tc = jax.tree_util.tree_flatten_with_path(convert.cache_to_numpy(
        model.init_cache(tcfg, 2, 8, device="cpu")))
    assert [(p, a.shape, a.dtype) for p, a in tc[0]] == \
        [(p, a.shape, a.dtype) for p, a in jc[0]]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_reduced("qwen3_14b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 8)


def test_init_params_is_seeded_and_frozen():
    cfg = tconfigs.get_reduced("glm4_9b")
    a = model.init_params(cfg, seed=3, device="cpu")
    b = model.init_params(cfg, seed=3, device="cpu")
    c = model.init_params(cfg, seed=4, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert not pa.requires_grad
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed, c.embed)
    assert len(a.layers) == cfg.num_layers
    assert float(a.embed.std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
def test_layers_match_jax(fraction):
    x = _randn(2, 5, 3, 16, seed=1)
    scale, bias = _randn(16, seed=2), _randn(16, seed=3)
    tx = torch.from_numpy(x)
    _close(layers.rmsnorm(tx, torch.from_numpy(scale)),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    _close(layers.layernorm(tx, torch.from_numpy(scale),
                            torch.from_numpy(bias)),
           jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias)))
    _close(layers.gelu(tx), jlayers.gelu(jnp.asarray(x)))
    _close(layers.silu(tx), jlayers.silu(jnp.asarray(x)))
    pos = np.arange(5) + 7
    _close(layers.apply_rope(tx, torch.from_numpy(pos), fraction=fraction,
                             theta=1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              fraction=fraction, theta=1e4))
    # decode layout: one position per batch row
    x1, pb = x[:, :1], np.array([[3], [11]])
    _close(layers.apply_rope(torch.from_numpy(x1), torch.from_numpy(pb),
                             fraction=fraction, theta=1e6),
           jlayers.apply_rope(jnp.asarray(x1), jnp.asarray(pb),
                              fraction=fraction, theta=1e6))


def test_rope_rotates_interleaved_pairs():
    """Position 1 with inv_freq 1 on the first pair: (x0, x1) rotates by one
    radian; the half-split layout would pair x0 with x2."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    y = layers.apply_rope(x, torch.tensor([1]), theta=1e4)
    assert y[0, 0, 0, 0] == pytest.approx(np.cos(1.0), abs=1e-6)
    assert y[0, 0, 0, 1] == pytest.approx(np.sin(1.0), abs=1e-6)
    assert float(y[0, 0, 0, 2]) == 0.0


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3_14b"), mlp_act=act)
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen3_14b"), mlp_act=act)
    jp = jmlp.init_mlp(KEY, jcfg, jnp.float32)
    tp = mlp.init_mlp(tcfg, torch.float32, torch.Generator().manual_seed(0))
    for name, value in jp.items():
        getattr(tp, name).data = convert.to_tensor(value, "cpu")
    x = _randn(2, 6, jcfg.d_model, seed=4)
    _close(mlp.mlp_forward(tp, torch.from_numpy(x), tcfg),
           jmlp.mlp_forward(jp, jnp.asarray(x), jcfg))


def _port_layers(jcfg, keys):
    """For the JAX leaf at path ``keys``: (the port's layer, the index
    along the leaf's leading axis, or None for a tail layer's leaf) for
    each layer the leaf holds."""
    if keys[0] == "layers":
        return [(i, i) for i in range(jcfg.num_layers)]
    if keys[0] == "enc_layers":
        return [(i, i) for i in range(jcfg.num_encoder_layers)]
    pat = jcfg.block_pattern
    n_rep = jcfg.num_layers // len(pat)
    if keys[0] == "pattern_layers":
        return [(g * len(pat) + keys[1], g) for g in range(n_rep)]
    return [(n_rep * len(pat) + keys[1], None)]


def test_params_from_jax_carries_every_weight(any_pair):
    arch, jcfg, jp, tcfg, tp = any_pair
    flat = {name: convert.to_numpy(p) for name, p in tp.named_parameters()}
    stacked = jax.tree_util.tree_flatten_with_path(jp)[0]
    stacks = ("layers", "pattern_layers", "tail_layers", "enc_layers")
    keys_of = [[getattr(p, "key", getattr(p, "idx", None)) for p in path]
               for path, _ in stacked]
    assert len(flat) == sum(
        len(_port_layers(jcfg, keys)) if keys[0] in stacks else 1
        for keys in keys_of)
    for keys, (_, leaf) in zip(keys_of, stacked):
        leaf = np.asarray(leaf)
        if keys[0] in stacks:
            one = keys[0] in ("layers", "enc_layers")
            rest = [str(k) for k in keys[1 if one else 2:]]
            into = "enc_layers" if keys[0] == "enc_layers" else "layers"
            for i, g in _port_layers(jcfg, keys):
                name = ".".join([into, str(i)] + rest)
                np.testing.assert_array_equal(
                    flat[name], leaf if g is None else leaf[g])
        else:
            np.testing.assert_array_equal(flat[".".join(keys)], leaf)
    bad = dict(jp, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_jax(bad, tcfg, "cpu")


@pytest.mark.parametrize("window", [None, 5])
def test_attention_prefill_path_matches_jax(pair, window):
    """_project_qkv, _attend and attention_forward (causal, windowed)."""
    arch, jcfg, jp, tcfg, tp = pair
    ja, ta = _layer0(jp)["attn"], tp.layers[0].attn
    x = _randn(2, 11, jcfg.d_model, seed=5) * 0.5
    pos = np.arange(11)
    jq, jk, jv = jattention._project_qkv(
        ja, jnp.asarray(x), jnp.asarray(x), jcfg, rope=True,
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    tq, tk, tv = attention._project_qkv(ta, tx, tx, tcfg, rope=True,
                                        q_positions=tpos, k_positions=tpos)
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        _close(got, want)
    _close(attention._attend(tq, tk, tv, tpos, tpos, causal=True,
                             window=window),
           jattention._attend(jq, jk, jv, jnp.asarray(pos),
                              jnp.asarray(pos), causal=True, window=window))
    _close(attention.attention_forward(ta, tx, tcfg, window=window),
           jattention.attention_forward(ja, jnp.asarray(x), jcfg,
                                        window=window))
    # cross-attention over a source of another length: no RoPE, no mask
    kv_x = _randn(2, 7, jcfg.d_model, seed=14) * 0.5
    _close(attention.attention_forward(ta, tx, tcfg, causal=False,
                                       kv_x=torch.from_numpy(kv_x)),
           jattention.attention_forward(ja, jnp.asarray(x), jcfg,
                                        causal=False,
                                        kv_x=jnp.asarray(kv_x)))


@pytest.mark.parametrize("variant", ["ring", "vector_pos", "int8", "window"])
def test_attention_decode_matches_jax(pair, variant):
    """Token-by-token decode of one layer: a cache shorter than the
    sequence (the ring wraps), per-slot positions, the int8 cache, and a
    sliding window; outputs and the cache after every step."""
    arch, jcfg, jp, tcfg, tp = pair
    if variant == "int8":
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    ja, ta = _layer0(jp)["attn"], tp.layers[0].attn
    B, steps = 2, 12
    cache_len = 8 if variant == "ring" else 16
    window = 4 if variant == "window" else None
    jc = jattention.init_kv_cache(jcfg, B, cache_len, jnp.float32)
    tc = attention.init_kv_cache(tcfg, B, cache_len, torch.float32, "cpu")
    xs = _randn(steps, B, 1, jcfg.d_model, seed=6) * 0.5
    for t in range(steps):
        pos = np.array([t, max(t - 3, 0)]) if variant == "vector_pos" \
            else np.int32(t)
        jo, jc = jattention.attention_decode(ja, jnp.asarray(xs[t]), jc,
                                             jnp.asarray(pos), jcfg,
                                             window=window)
        to, tc = attention.attention_decode(ta, torch.from_numpy(xs[t]), tc,
                                            torch.as_tensor(pos), tcfg,
                                            window=window)
        _close(to, jo)
        for name in jc:
            _close(tc[name], jc[name])
    assert tc["k"].dtype == (torch.int8 if variant == "int8"
                             else torch.float32)


def test_forward_matches_jax(any_pair):
    arch, jcfg, jp, tcfg, tp = any_pair
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 24))
    batch = {"tokens": toks}
    if jcfg.is_encoder_decoder:
        batch["enc_media"] = _randn(2, jcfg.frontend_len, jcfg.d_model,
                                    seed=15)
    jl, jaux = jmodel.forward(jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jcfg)
    tl, aux = model.forward(tp, batch, tcfg)
    assert tuple(tl.shape) == (2, 24, jcfg.padded_vocab)
    # the MoE load-balance loss summed over layers; 0 for the other kinds
    assert float(aux) == pytest.approx(float(jaux), abs=1e-5)
    assert (float(aux) > 0) == (arch.startswith("granite"))
    _close(tl, jl)


def test_block_kinds_and_blocks_match_jax(any_pair):
    arch, jcfg, jp, tcfg, tp = any_pair
    from repro.models import blocks as jblocks
    assert blocks.block_kinds(tcfg) == jblocks.block_kinds(jcfg)
    kind = blocks.block_kinds(tcfg)[0]
    x = _randn(1, 9, jcfg.d_model, seed=8) * 0.5
    jy, _ = jblocks.block_forward(_layer0(jp), jnp.asarray(x), jcfg, kind)
    ty, _ = blocks.block_forward(tp.layers[0], torch.from_numpy(x), tcfg,
                                 kind)
    _close(ty, jy)


# bf16 reduced qwen3-14b, JAX and the port on the same bf16 weights: both
# round every matrix product and norm to bf16, but at their own points
# (XLA's and torch's CPU kernels), so the logits differ by bf16 rounding
# carried through two layers.  Measured on this CPU host: 9.8e-3 max |dev|
# (one bf16 ulp at 1.3), 1.5e-3 mean, on logits of max |logit| 1.31
# (2 layers, 24 tokens, this seed); the limit is 3x the max.
ATOL_BF16 = 3e-2


def test_forward_bf16_matches_jax():
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3_14b"),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen3_14b"),
                               param_dtype="bfloat16")
    jp = jmodel.init_params(jcfg, KEY)
    tp = convert.params_from_jax(jp, tcfg, "cpu")
    assert tp.embed.dtype == torch.bfloat16
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 24))
    jl, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jcfg)
    tl, _ = model.forward(tp, {"tokens": toks}, tcfg)
    assert tl.dtype == torch.bfloat16
    dev = np.abs(convert.to_numpy(tl) - np.asarray(jl, np.float32)).max()
    assert dev <= ATOL_BF16, dev
