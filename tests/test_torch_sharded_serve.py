"""Torch port, the sharded serve step on the CPU.

``launch.serve.make_jitted_serve_step`` (tensor-parallel decode over
"model", a sequence-sharded cache; ``models.tp``) across gloo groups of 2
and 4 ranks (``repro_torch.launch.ranks.spawn``; workers in
``tests/_torch_ranks.py``, no jax) and at one rank in this process,
against JAX's ``make_serve_step`` under ``jax.jit`` — and, at mesh (1, 1),
JAX's own ``make_jitted_serve_step`` on a one-device host mesh, where its
specs are valid (``_conv_cache``) — for 12
fp32 greedy steps from the same JAX-initialised weights and numpy-made
prompts: reduced qwen3, command-r (layernorm, a tied head), granite-moe
on both routes (the scatter route with its rows split over "data", ROADMAP
Queue 1 item 13.7), mamba2, recurrentgemma (3 layers: a tail layer, and a
window of 8 whose ring wraps) and seamless (decode after ``prefill`` with
its frames), each on meshes (1, 1), (2, 1), (1, 2), (2, 2) and (1, 4);
then a (B,) position vector, an int8 KV cache stepped from zeros, a batch
that the data axis does not divide, and a vocab that the model axis does
not divide.  Reduced qwen3 at (1, 4) splits wk and wv mid-head (KV = 2,
D = 64: 32-column blocks), recurrentgemma's KV = 1 does at every model
axis above 1.  Tokens equal, logits within 1e-5; no ``Gather`` forward in
a step, and its collective bytes under the activations' bound.  Both
groups start together in threads; JAX's references are computed while
they run.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as tr
import repro.configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models.prefill import prefill as jprefill
import repro_torch.configs as tconfigs
from repro_torch.launch import mesh as M
from repro_torch.launch import ranks as tranks
from repro_torch.launch import sharding as shd
from repro_torch.models import model
from _torch_cases import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
STEPS, PROMPT, MAX_LEN, B = 12, 4, 16, 4
# fp32 on both sides, summed in other orders (XLA on the CPU vs torch,
# whole products vs per-rank partial sums reduced across ranks)
TOL = 1e-5
# The int8 KV cache rounds k and v to levels of 1/127 of each row's
# absmax: an fp32 difference of one ulp moves an entry across a rounding
# boundary now and then, one level.  The port's one-card step against
# JAX's, on this case's weights and prompt, already reads 1.9e-3 on the
# logits by step 8 (each package's own fp32 roundings); the sharded step
# adds flips of its own (its projections summed in other orders).  So the
# int8 case holds its logits to INT8_TOL and its cache to the levels:
# every entry within one level of JAX's, at most INT8_FLIPS of them off.
INT8_TOL = 5e-3
INT8_FLIPS = 1e-2
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]
FAMILIES = {
    "qwen3": ("qwen3_14b", {}),
    "command-r": ("command_r_35b", {}),
    "granite": ("granite_moe_1b_a400m", {}),
    "granite scatter": ("granite_moe_1b_a400m", {"moe_routing": "scatter"}),
    "mamba2": ("mamba2_370m", {}),
    "recurrentgemma": ("recurrentgemma_2b",
                       {"num_layers": 3, "sliding_window": 8}),
    "seamless": ("seamless_m4t_large_v2", {}),
}
# key: (its reference: the same weights, prompt and steps on every mesh,
# arch, mesh, rows, config overrides, position offsets or None)
CASES = {f"{fam} {d}x{m}": (fam, arch, (d, m), B, over, None)
         for fam, (arch, over) in FAMILIES.items() for d, m in MESHES}
CASES.update({key: (key, *spec) for key, spec in {
    "qwen3 2x2 pos vector": ("qwen3_14b", (2, 2), B, {}, [0, 3, 1, 2]),
    "qwen3 1x4 int8": ("qwen3_14b", (1, 4), B, {"kv_cache_dtype": "int8"},
                       None),
    "qwen3 2x2 rows 3": ("qwen3_14b", (2, 2), 3, {}, None),
    "qwen3 1x4 vocab 510": ("qwen3_14b", (1, 4), B,
                            {"vocab_size": 510, "vocab_pad_multiple": 1},
                            None),
}.items()})


def _cfgs(arch, over):
    return (dataclasses.replace(jconfigs.get_reduced(arch),
                                param_dtype="float32", **over),
            dataclasses.replace(tconfigs.get_reduced(arch),
                                param_dtype="float32", **over))


def _inputs(ref, arch, rows, over):
    """A reference's weights (JAX's init, numpy), prompt and frames, made
    from numpy seeds."""
    jcfg, _ = _cfgs(arch, over)
    rng = np.random.default_rng(len(ref))
    out = dict(tree=jax.tree.map(np.asarray, jmodel.init_params(jcfg, KEY)),
               prompt=rng.integers(0, jcfg.vocab_size, (rows, PROMPT)),
               enc_media=None)
    if jcfg.is_encoder_decoder:
        out["enc_media"] = rng.standard_normal(
            (rows, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
    return out


def _case(spec, inputs):
    ref, arch, shape, rows, over, offsets = spec
    if ref not in inputs:
        inputs[ref] = _inputs(ref, arch, rows, over)
    return dict(ref=ref, arch=arch, shape=shape, cfg=over, steps=STEPS,
                max_len=MAX_LEN, offsets=offsets, **inputs[ref])


def _reference(c, step):
    """JAX's greedy loop through ``step`` (predictions (steps, B), logits
    (steps, B, V)): the prompt stepped in, or for the encoder-decoder
    ``prefill`` with the frames, then greedy."""
    jcfg, _ = _cfgs(c["arch"], c["cfg"])
    jp = jax.tree.map(jnp.asarray, c["tree"])
    prompt, p0 = jnp.asarray(c["prompt"]), 0
    if jcfg.is_encoder_decoder:
        logits, cache, p0 = jprefill(jp, {"tokens": prompt, "enc_media":
                                          jnp.asarray(c["enc_media"])},
                                     jcfg, c["max_len"])
        prompt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    else:
        cache = jmodel.init_cache(jcfg, len(prompt), c["max_len"])
    offsets = 0 if c["offsets"] is None else jnp.asarray(c["offsets"])
    tok, nexts, logits_all = prompt[:, 0], [], []
    for t in range(c["steps"]):
        nxt, logits, cache = step(jp, cache, tok,
                                  jnp.asarray(p0 + t + offsets, jnp.int32))
        nexts.append(np.asarray(nxt))
        logits_all.append(np.asarray(logits))
        tok = prompt[:, t + 1] if t + 1 < prompt.shape[1] else nxt
    return (np.stack(nexts), np.stack(logits_all),
            jax.tree.map(np.asarray, cache))


def _conv_cache(cfg) -> bool:
    """Whether the model keeps a conv cache: there JAX's ``cache_pspecs``
    names "model" twice at a model axis of 1 ("conv" ends in "v", so the
    KV cache's rule splits its W-1 dim too) and ``NamedSharding``
    refuses the spec, so JAX's jitted step cannot run."""
    return cfg.arch_type in ("ssm", "hybrid")


def _references(c, one_device: bool):
    jcfg, _ = _cfgs(c["arch"], c["cfg"])
    out = {"jit": _reference(c, jax.jit(jserve.make_serve_step(jcfg)))}
    if one_device and not _conv_cache(jcfg):
        # a mesh of automatic axes: ``jmesh.make_host_mesh``'s
        # ``jax.make_mesh`` makes explicit ones on JAX 0.9, where the
        # reference's jitted steps refuse their sharded contractions (as
        # tests/test_distributed.py's known failure of the train step)
        host = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        step, _ = jserve.make_jitted_serve_step(
            jcfg, host, len(c["prompt"]), c["max_len"])
        with jmesh.use_mesh(host):
            out["mesh"] = _reference(c, step)
    return out


@pytest.fixture(scope="module")
def runs():
    inputs = {}
    cases = {k: _case(v, inputs) for k, v in CASES.items()}
    by_size = {}
    for key, c in cases.items():
        by_size.setdefault(c["shape"][0] * c["shape"][1], {})[key] = c
    pool = concurrent.futures.ThreadPoolExecutor(len(by_size) + 1)
    futs = {k: pool.submit(tranks.spawn, tr.sharded_serve, k, (group,),
                           device="cpu", deadline_s=400.0, timeout_s=200.0)
            for k, group in by_size.items() if k > 1}
    futs[1] = pool.submit(lambda: [tr.sharded_serve(0, by_size[1])])
    futs["phase 20"] = pool.submit(_phase_20)
    refs = {}
    for c in cases.values():
        if c["ref"] not in refs:
            refs[c["ref"]] = _references(c, any(
                o["ref"] == c["ref"] and o["shape"] == (1, 1)
                for o in cases.values()))
    yield cases, futs, refs
    pool.shutdown(wait=True)


def _phase_20():
    """``chip_smoke.py`` phase 20 on four gloo ranks of the CPU, on the
    reduced qwen3-32b at the phase's depth, batch, steps and limits."""
    import chip_smoke
    return chip_smoke.serve_sharded_phase(torch, device="cpu", reduced=True)


def _rows(shape, rows, rank):
    """The global rows rank ``rank`` serves: its data block where the
    data axis divides them."""
    d = shape[0]
    if d > 1 and rows % d == 0:
        k = rows // d
        return slice(rank // shape[1] * k, (rank // shape[1] + 1) * k)
    return slice(0, rows)


def _outs(runs, key):
    cases, futs, refs = runs
    c = cases[key]
    outs = futs[c["shape"][0] * c["shape"][1]].result(timeout=600)
    refs = dict(refs[c["ref"]])
    if c["shape"] != (1, 1):
        refs.pop("mesh", None)
    return c, [o[key] for o in outs], refs


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_serve_step_matches_jax(runs, key):
    """Every rank's predictions are JAX's for its rows and its logits
    within 1e-5, the same on every rank of its data group; at mesh (1, 1)
    JAX's own jitted step on a host mesh gives the same; the specs the
    step returns are ``param_pspecs(..., fsdp=False)`` and
    ``cache_pspecs``."""
    c, outs, refs = _outs(runs, key)
    rows = len(c["prompt"])
    int8 = c["cfg"].get("kv_cache_dtype") == "int8"
    for name, (nexts, logits, _) in refs.items():
        for r, o in enumerate(outs):
            sl = _rows(c["shape"], rows, r)
            assert np.array_equal(o["next"].numpy(), nexts[:, sl]), (name, r)
            dev = np.abs(o["logits"].numpy() - logits[:, sl]).max()
            assert dev <= (INT8_TOL if int8 else TOL), (key, name, r, dev)
    per = c["shape"][1]
    for r, o in enumerate(outs):
        mate = outs[r // per * per]
        assert torch.equal(o["logits"], mate["logits"]), (key, r)
    _, tcfg = _cfgs(c["arch"], c["cfg"])
    mesh = M.abstract_mesh(c["shape"], ("data", "model"))
    p_specs, c_specs = outs[0]["specs"]
    assert p_specs == shd.param_pspecs(model.abstract_params(tcfg), mesh,
                                       fsdp=False)
    assert c_specs == shd.cache_pspecs(
        shd.abstract_cache(tcfg, rows, c["max_len"]), tcfg, mesh)


def _rank_block(a, spec, shape, rank):
    """Rank ``rank``'s block of a whole array on the (data, model) mesh of
    ``shape`` (row-major coordinates)."""
    coords = {"data": rank // shape[1], "model": rank % shape[1]}
    sizes = dict(zip(("data", "model"), shape))
    for d, ax in enumerate(spec):
        if ax is not None and sizes[ax] > 1:
            k = a.shape[d] // sizes[ax]
            a = np.take(a, np.arange(coords[ax] * k, (coords[ax] + 1) * k),
                        axis=d)
    return a


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, M.P):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("key", [k for k in CASES if k.endswith(
    ("2x2", "1x4", "int8", "rows 3"))])
def test_cache_blocks_match_jax(runs, key):
    """After the steps each rank's cache blocks are the blocks of JAX's
    whole cache under ``c_specs`` (fp32 within 1e-5; int8 within one
    level, few entries off): the new rows were written by the ranks whose
    blocks hold their slots, and a tail layer's whole-batch state holds
    every data group's rows."""
    c, outs, refs = _outs(runs, key)
    want = dict(_leaves(refs["jit"][2]))
    for r, o in enumerate(outs):
        specs = dict(_leaves(o["specs"][1]))
        got = dict(_leaves(o["cache"]))
        assert got.keys() == want.keys() == specs.keys()
        for path, blk in got.items():
            w = _rank_block(want[path], specs[path], c["shape"], r)
            assert blk.shape == w.shape, (path, blk.shape, w.shape)
            g = blk.numpy()
            if g.dtype == np.int8:
                off = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert off.max() <= 1 and off.mean() <= INT8_FLIPS, path
            else:
                dev = np.abs(g - w).max()
                assert dev <= TOL * max(1.0, np.abs(w).max()), (path, dev)


def _activation_bound(cfg, shape, rows) -> int:
    """Bytes a step's collectives may move on a rank without a weight: per
    layer at most 12 collectives (the gathers of q, k and v, the
    attention's pmax and psum, the row-parallel psums, and the same for
    the cross-attention; the SSM's and the LRU's gathers), each of one
    fp32 activation of this rank's rows at the widest width any of them
    has (whole over "model": d, q with a sum a head, the SSM's input
    projection, its conv channels, the LRU's width); the embedding's psum
    and the head's gather of V; a tail layer's conv and LRU state of
    every row, gathered over "data"."""
    d = shape[0]
    mine = rows // d if d > 1 and rows % d == 0 else rows
    width = max(cfg.d_model, cfg.attn_dim + cfg.num_heads,
                2 * cfg.ssm_dinner + 2 * cfg.ssm_state + cfg.ssm_nheads,
                cfg.ssm_dinner + 2 * cfg.ssm_state, cfg.lru_width)
    tail = cfg.num_layers * rows * cfg.conv_width * cfg.lru_width
    return 4 * (mine * (12 * cfg.num_layers * width + cfg.d_model
                        + cfg.padded_vocab) + tail)


@pytest.mark.parametrize("key", ["qwen3 2x2", "granite scatter 2x2",
                                 "mamba2 1x4", "recurrentgemma 2x2",
                                 "seamless 1x4"])
def test_no_weight_is_gathered_in_a_step(runs, key):
    """No ``Gather`` forward runs in the steps (reading one parametrized
    leaf after them makes one: the control), and each step's collective
    bytes stay under the activations' bound, itself below what one
    all-gather of the weights' blocks would bring a rank."""
    c, outs, _ = _outs(runs, key)
    _, tcfg = _cfgs(c["arch"], c["cfg"])
    bound = _activation_bound(tcfg, c["shape"], len(c["prompt"]))
    weights = 4 * sum(p.numel() for p in
                      model.abstract_params(tcfg).parameters())
    assert bound < weights * (1 - 1 / c["shape"][1]) / 4
    for o in outs:
        assert o["gathers"] == 0
        assert o["gathers_after_a_read"] >= 1
        for step_bytes in o["comm_bytes"]:
            total = sum(step_bytes.values())
            assert 0 < total <= bound, (key, step_bytes, bound)


def test_phase_20_rehearsal(runs):
    """``chip_smoke.py`` phase 20 runs its checks on the CPU (the reduced
    config): on every rank the fp32 copy's predictions equal the one-rank
    step's and its logits are within the fp32 limit, bf16 fed the
    reference's tokens within its limit with the control above it, no
    ``Gather`` forward and no kernel launch."""
    import chip_smoke
    out = runs[1]["phase 20"].result(timeout=600)
    assert set(out["ranks"]) == {"float32", "bfloat16"}
    for dt, recs in out["ranks"].items():
        assert len(recs) == 4
        for r in recs:
            assert r["gather_forwards"] == 0 and not r["launches"]
            assert r["dev"] <= chip_smoke.SERVE_TOL[dt] < r["control"]
            assert r["teacher"] == (dt == "bfloat16")
            if dt == "float32":
                assert r["next_equal"]
