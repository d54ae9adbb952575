"""Torch port, training on the CPU: ``model.loss_fn`` and its gradient by
autograd against ``jax.value_and_grad(repro.models.model.loss_fn)`` for
every family of the registry (reduced, fp32, JAX-initialised weights), the
per-layer remat (``torch.utils.checkpoint``) against the same pass
without it, and ``launch.train.make_train_step`` against JAX's jitted
step.  Inputs are numpy arrays from seeds, shared by both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data.synthetic import token_stream as jtoken_stream
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
import repro_torch.configs as tconfigs
from repro_torch.data.packing import pack_documents, synthetic_documents
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import train
from repro_torch.models import convert, model
from repro_torch.optim import AdamWConfig, adamw_init
from _torch_cases import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
B, S = 2, 32
# fp32 on both sides, summed in other orders (XLA on the CPU vs torch):
# the loss within 1e-5; each gradient leaf within 2e-5 of its largest
# entry (measured at most 5.7e-6 over the ten families: mamba2's A_log).
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
# the train step: loss and gnorm after up to three AdamW updates
STEP_TOL = 1e-4


def _batch(cfg, seed):
    """A packed batch of short documents (labels -1 at each document's
    start), with the VLM's media prefix or the encoder-decoder's frames."""
    rows = pack_documents(synthetic_documents(cfg.vocab_size, seed,
                                              mean_len=12), S)
    items = [next(rows) for _ in range(B)]
    batch = {k: np.stack([x[k] for x in items]) for k in ("tokens",
                                                          "labels")}
    rng = np.random.default_rng(seed + 100)
    if cfg.frontend == "vision":
        batch["media"] = (rng.standard_normal((B, cfg.frontend_len,
                                               cfg.d_model)) * 0.02
                          ).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_media"] = (rng.standard_normal((B, 16, cfg.d_model))
                              * 0.02).astype(np.float32)
    return batch


def _grads(lm):
    return {name: (p.grad if p.grad is not None else torch.zeros_like(p))
            for name, p in lm.named_parameters()}


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch),
                               param_dtype="float32")
    jp = jmodel.init_params(jcfg, KEY)
    batch = _batch(tcfg, seed=tconfigs.ARCHS.index(arch))
    assert (batch["labels"] < 0).any() and (batch["labels"] >= 0).any()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = model.trainable_(convert.params_from_jax(jp, tcfg, "cpu"))
    loss = model.loss_fn(lm, batch, tcfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    want = convert.flat_from_jax(jgrads, tcfg)
    got = _grads(lm)
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        dev = np.abs(g.numpy() - w).max()
        assert dev <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (name, dev)


@pytest.mark.parametrize("layers", [2, 3])
def test_loss_and_grads_match_jax_at_head_dim_256(layers):
    """The registry's one D = 256 model at its head dim: the reduced
    recurrentgemma with head_dim 256 and a window of 12 positions, shorter
    than the batch's 32 (so the window masks), fp32; 2 layers (rec, attn)
    and 3 (a tail rec layer after the pattern).  The port's loss and every
    gradient against ``jax.value_and_grad(loss_fn)`` on the same
    ``params_from_jax`` weights, at LOSS_TOL and GRAD_TOL."""
    def cut(cfg):
        return dataclasses.replace(cfg, head_dim=256, sliding_window=12,
                                   num_layers=layers, param_dtype="float32")
    jcfg = cut(jconfigs.get_reduced("recurrentgemma_2b"))
    tcfg = cut(tconfigs.get_reduced("recurrentgemma_2b"))
    assert tcfg.sliding_window < S
    jp = jmodel.init_params(jcfg, KEY)
    batch = _batch(tcfg, seed=11 + layers)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = model.trainable_(convert.params_from_jax(jp, tcfg, "cpu"))
    assert lm.layers[1].attn.wq.shape[-1] == tcfg.num_heads * 256
    loss = model.loss_fn(lm, batch, tcfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    want = convert.flat_from_jax(jgrads, tcfg)
    got = _grads(lm)
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        dev = np.abs(g.numpy() - w).max()
        assert dev <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (name, dev)


@pytest.mark.parametrize("arch", ["qwen3_14b", "internvl2_1b",
                                  "seamless_m4t_large_v2",
                                  "recurrentgemma_2b"])
def test_remat_gives_the_same_loss_and_grads(arch, monkeypatch):
    """In train mode every layer (the encoder's too) runs under
    ``torch.utils.checkpoint``; loss and grads equal those of the same
    pass without it (``mode="prefill"``: the same masks, no remat) bit
    for bit."""
    cfg = dataclasses.replace(tconfigs.get_reduced(arch),
                              param_dtype="float32")
    lm = model.init_params(cfg, seed=1, device="cpu", trainable=True)
    batch = _batch(cfg, seed=5)
    calls = []

    def counted(fn, *args, **kw):
        calls.append(1)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)
    monkeypatch.setattr(model, "checkpoint", counted)
    runs = []
    for mode in ("train", "prefill"):
        lm.zero_grad(set_to_none=True)
        loss = model.loss_fn(lm, batch, cfg, mode=mode)
        loss.backward()
        runs.append((loss.detach(), _grads(lm)))
    assert len(calls) == cfg.num_layers + cfg.num_encoder_layers * bool(
        cfg.is_encoder_decoder)
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


def test_frozen_model_and_other_remat_policies():
    """A serving model is frozen (no remat, no graph); a trainable one
    under the "dots" or "names" policy gives "full"'s loss and gradients
    (``tests/test_torch_remat.py`` holds them to JAX's)."""
    cfg = tconfigs.get_reduced("qwen3_14b")
    batch = _batch(cfg, seed=0)
    lm = model.init_params(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in lm.parameters())
    assert not model.loss_fn(lm, batch, cfg).requires_grad
    runs = {}
    for policy in ("full", "dots", "names"):
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        lm = model.init_params(pcfg, seed=0, device="cpu", trainable=True)
        loss = model.loss_fn(lm, batch, pcfg)
        loss.backward()
        runs[policy] = (loss.detach(), _grads(lm))
    for policy in ("dots", "names"):
        assert torch.equal(runs[policy][0], runs["full"][0])
        for name, g in runs["full"][1].items():
            assert torch.equal(runs[policy][1][name], g), (policy, name)


@pytest.mark.parametrize("arch", ["qwen3_14b", "granite_moe_1b_a400m",
                                  "granite_moe_3b_a800m",
                                  "granite_moe_3b_a800m:scatter",
                                  "internvl2_1b", "seamless_m4t_large_v2",
                                  "glm4_9b", "command_r_35b"])
def test_train_step_matches_jax(arch):
    """Three steps of ``make_train_step`` against JAX's jitted step from
    the same weights and batches: loss and gnorm at each step, and the
    parameters after.  "name:scatter" takes the MoE config's scatter route
    (capacity factor 1.25: assignments drop).  The VLM and the
    encoder-decoder are fed ``_batch`` with their "media" or "enc_media"
    (``token_stream`` gives neither); the others ``token_stream``."""
    arch, _, routing = arch.partition(":")
    over = dict(param_dtype="float32")
    if routing:
        over["moe_routing"] = routing
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), **over)
    jp = jmodel.init_params(jcfg, KEY)
    jstate = jadamw_init(jp)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(lr=1e-3),
                                     total_steps=10))
    lm = model.trainable_(convert.params_from_jax(jp, tcfg, "cpu"))
    state = adamw_init(lm)
    step = train.make_train_step(tcfg, AdamWConfig(lr=1e-3), total_steps=10)
    if tcfg.frontend == "vision" or tcfg.is_encoder_decoder:
        batches = [_batch(tcfg, seed=20 + i) for i in range(3)]
        assert {"media", "enc_media"} & set(batches[0])
        jstream = ({k: jnp.asarray(v) for k, v in b.items()}
                   for b in batches)
        stream = iter(batches)
    else:
        jstream = jtoken_stream(jcfg, B, S, seed=3)
        stream = token_stream(tcfg, B, S, seed=3, device="cpu")
    for _ in range(3):
        jb, tb = next(jstream), next(stream)
        np.testing.assert_array_equal(np.asarray(jb["tokens"]),
                                      np.asarray(tb["tokens"]))
        jp, jstate, jm = jstep(jp, jstate, jb)
        lm, state, m = step(lm, state, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_TOL
        assert abs(float(m["gnorm"]) - float(jm["gnorm"])) <= STEP_TOL * max(
            1.0, float(jm["gnorm"]))
    assert int(state["step"]) == int(jstate["step"]) == 3
    want = convert.flat_from_jax(jp, tcfg)
    for name, p in lm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                   atol=STEP_TOL, rtol=0)


def test_make_jitted_train_step_names_the_roadmap_item(monkeypatch):
    """The sharded step runs (``tests/test_torch_sharded_train.py``).  MoE's
    scatter route under a split of the rows, whose capacity depends on the
    global token count, raised naming ROADMAP Queue 1 item 13.7 until that
    item; now it slots its tokens in global order and the step runs: under
    a forced split (a mesh of one rank splits no rows) its loss and gnorm
    are the one-rank step's."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    cfg = dataclasses.replace(tconfigs.get_reduced("granite_moe_1b_a400m"),
                              moe_routing="scatter")
    mesh = M.make_host_mesh()
    batch = _batch(cfg, seed=0)
    step, (p_specs, o_specs, b_specs) = train.make_jitted_train_step(
        cfg, AdamWConfig(), mesh, batch)
    assert set(p_specs) == set(o_specs["m"]) and b_specs["tokens"] == M.P(
        "data")
    lm = shd.init_sharded(cfg, mesh, seed=0, device="cpu")
    state = shd.init_opt_state(cfg, mesh, "cpu")
    ref = model.init_params(cfg, seed=0, device="cpu", trainable=True)
    _, _, want = train.make_train_step(cfg, AdamWConfig())(
        ref, adamw_init(ref), batch)
    monkeypatch.setattr(train, "row_axes", lambda rows, mesh: ("data",))
    with M.bound(mesh):
        _, _, got = step(lm, state, batch)
    for k in ("loss", "gnorm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 * max(
            1.0, float(want[k])), k
