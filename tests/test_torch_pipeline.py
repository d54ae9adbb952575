"""Torch port, the training pipeline around the model on the CPU: the
synthetic batches and input shapes (``data.synthetic``), the packed
document pipeline (``data.packing``), the schedules, AdamW, checkpoints
(interchangeable with JAX's for fp32 trees, both ways) and the ``cli``'s
``train`` lines, each against the JAX package on the same seeds; the
``cli``'s ``dryrun``."""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.data import packing as jpacking
from repro.data import synthetic as jsyn
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
import repro_torch.configs as tconfigs
from repro_torch import checkpoint
from repro_torch.data import packing, synthetic
from repro_torch.launch import cli
from repro_torch.models import convert, model
from repro_torch.optim import adamw, schedule
from repro_torch.launch.train import make_train_step
from _torch_cases import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
SMALL = synthetic.InputShape("small", 64, 2, "train")
# AdamW against JAX: the same fp32 arithmetic, the global norm summed over
# the leaves in another order.
ADAMW_RTOL = 1e-6


def _np(t):
    return convert.to_numpy(t) if isinstance(t, torch.Tensor) else t


def _same(jax_arr, t):
    """Bit for bit, dtype included (bf16 compared through its bits)."""
    a = np.asarray(jax_arr)
    if t.dtype == torch.bfloat16:
        assert a.dtype.name == "bfloat16"
        np.testing.assert_array_equal(a.view(np.int16),
                                      t.view(torch.int16).numpy())
        return
    assert str(t.dtype) == f"torch.{a.dtype.name}"
    np.testing.assert_array_equal(a, t.numpy())


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_sample_batch_and_decode_state_equal_jax(arch):
    for jcfg, tcfg, shape in (
            (jconfigs.get_reduced(arch), tconfigs.get_reduced(arch), SMALL),
            (jconfigs.get(arch), tconfigs.get(arch),
             synthetic.InputShape("one", 300, 1, "prefill"))):
        want = jsyn.sample_batch(jcfg, jsyn.InputShape(*dataclasses.astuple(
            shape)), seed=3)
        got = synthetic.sample_batch(tcfg, shape, seed=3, device="cpu")
        assert set(got) == set(want)
        for key in want:
            _same(want[key], got[key])
    tok, pos = synthetic.sample_decode_state(tcfg, "decode_32k", seed=2,
                                             device="cpu")
    jtok, jpos = jsyn.sample_decode_state(jcfg, "decode_32k", seed=2)
    _same(jtok, tok)
    _same(jpos, pos)


def test_sample_batch_at_an_assigned_shape():
    got = synthetic.sample_batch(tconfigs.get("qwen3_14b"), "train_4k",
                                 seed=1, device="cpu")
    want = jsyn.sample_batch(jconfigs.get("qwen3_14b"), "train_4k", seed=1)
    for key in want:
        _same(want[key], got[key])


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_input_specs_match_jax(arch):
    for shape in synthetic.SHAPES:
        want = jsyn.input_specs(jconfigs.get(arch), shape)
        got = synthetic.input_specs(tconfigs.get(arch), shape)
        assert set(got) == set(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape)
            assert str(got[key].dtype) == f"torch.{spec.dtype.name}"


def test_token_stream_equals_jax():
    jcfg, tcfg = (jconfigs.get_reduced("qwen3_14b"),
                  tconfigs.get_reduced("qwen3_14b"))
    want = jsyn.token_stream(jcfg, 3, 40, seed=7)
    got = synthetic.token_stream(tcfg, 3, 40, seed=7, device="cpu")
    for _ in range(3):
        w, g = next(want), next(got)
        for key in ("tokens", "labels"):
            _same(w[key], g[key])


@pytest.mark.parametrize("seq_len,seed", [(32, 0), (100, 3), (256, 11)])
def test_packed_batches_equal_jax(seq_len, seed):
    want = jpacking.packed_batches(500, 4, seq_len, seed=seed)
    got = packing.packed_batches(500, 4, seq_len, seed=seed)
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(w) == set(g)
        for key in w:
            assert w[key].dtype == g[key].dtype
            np.testing.assert_array_equal(w[key], g[key])
        assert packing.packing_efficiency(g) == \
            jpacking.packing_efficiency(w)


def test_schedules_match_jax():
    for step in range(121):
        for args in ((120, 20), (100, 10), (50, 0)):
            total, warmup = args
            want = float(jschedule.cosine_schedule(jnp.int32(step), total,
                                                   warmup=warmup))
            for s in (step, torch.tensor(step, dtype=torch.int32)):
                got = schedule.cosine_schedule(s, total, warmup=warmup)
                assert got.dtype == torch.float32
                assert abs(float(got) - want) <= 1e-7
        assert abs(float(schedule.linear_warmup(step, 7))
                   - float(jschedule.linear_warmup(step, 7))) <= 1e-7


def test_schedules():
    """JAX's test_schedules, on the port."""
    assert abs(float(schedule.linear_warmup(0, 10)) - 0.1) < 1e-6
    assert float(schedule.cosine_schedule(0, 100, warmup=10)) < 0.2
    assert abs(float(schedule.cosine_schedule(100, 100, warmup=10))
               - 0.1) < 1e-5
    mid = float(schedule.cosine_schedule(55, 100, warmup=10))
    assert 0.1 < mid < 1.0


@pytest.mark.parametrize("grad_scale", [0.01, 30.0])
def test_adamw_update_matches_jax(grad_scale):
    """Params (one leaf bf16), grads and state through three updates;
    grad_scale 30 clips (gnorm > grad_clip), 0.01 does not."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    P = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    jp["b"] = jp["b"].astype(jnp.bfloat16)
    tp = {k: torch.tensor(v) for k, v in P.items()}
    tp["b"] = tp["b"].to(torch.bfloat16)
    jstate, tstate = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    jcfg, tcfg = jadamw.AdamWConfig(lr=1e-2), adamw.AdamWConfig(lr=1e-2)
    for i in range(3):
        G = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
             for k, s in shapes.items()}
        jp, jstate, jg = jadamw.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in G.items()}, jstate, jcfg,
            0.5 + 0.1 * i)
        tp, tstate, tg = adamw.adamw_update(
            tp, {k: torch.tensor(v) for k, v in G.items()}, tstate, tcfg,
            0.5 + 0.1 * i)
        assert (float(jg) > tcfg.grad_clip) == (grad_scale > 1)
        assert abs(float(tg) - float(jg)) <= ADAMW_RTOL * float(jg)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        assert tstate["step"].dtype == torch.int32
        for k in shapes:
            assert tp[k].dtype == (torch.bfloat16 if k == "b"
                                   else torch.float32)
            for want, got in ((jp[k], tp[k]), (jstate["m"][k],
                                               tstate["m"][k]),
                              (jstate["v"][k], tstate["v"][k])):
                w = np.asarray(want.astype(jnp.float32))
                np.testing.assert_allclose(
                    _np(got), w, rtol=0,
                    atol=ADAMW_RTOL * max(np.abs(w).max(), 1e-30))


def test_adamw_descends_quadratic():
    """JAX's test_adamw_descends_quadratic, on the port."""
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, gnorm = adamw.adamw_update(params, grads, opt, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_grad_clip():
    """JAX's test_adamw_grad_clip: gnorm is reported before the clip."""
    cfg = adamw.AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    opt = adamw.adamw_init(params)
    _, _, gnorm = adamw.adamw_update(params, {"w": torch.full((3,), 100.0)},
                                     opt, cfg)
    assert float(gnorm) > 100.0


def _trained(arch, dtype="float32", steps=1):
    """A reduced port model and its AdamW state after ``steps`` steps."""
    cfg = dataclasses.replace(tconfigs.get_reduced(arch), param_dtype=dtype)
    lm = model.init_params(cfg, seed=0, device="cpu", trainable=True)
    state = adamw.adamw_init(lm)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-2))
    stream = synthetic.token_stream(cfg, 2, 16, seed=0, device="cpu")
    for _ in range(steps):
        lm, state, _ = step(lm, state, next(stream))
    return cfg, lm, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, dtype):
    cfg, lm, state = _trained("qwen3_14b", dtype)
    checkpoint.save_train_state(tmp_path / "ck", lm, state, cfg, step=7)
    lm2, state2, step = checkpoint.restore_train_state(tmp_path / "ck", cfg,
                                                       device="cpu")
    assert step == 7
    assert all(p.requires_grad for p in lm2.parameters())
    own = dict(lm2.named_parameters())
    for name, p in lm.named_parameters():
        assert p.dtype == own[name].dtype and torch.equal(p, own[name])
    for key in ("m", "v"):
        for name, t in state[key].items():
            assert torch.equal(t, state2[key][name])
    assert torch.equal(state["step"], state2["step"])


@pytest.mark.parametrize("arch", ["qwen3_14b", "recurrentgemma_2b"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    jcfg = jconfigs.get_reduced(arch)
    jp = jmodel.init_params(jcfg, KEY)
    grads = jax.tree.map(lambda t: jnp.full_like(t, 0.01), jp)
    jp, js, _ = jax.jit(lambda p, g: jadamw.adamw_update(
        p, g, jadamw.adamw_init(p), jadamw.AdamWConfig()))(jp, grads)
    jsave(tmp_path / "ck", {"params": jp, "opt": js}, step=5)
    tcfg = tconfigs.get_reduced(arch)
    lm, state, step = checkpoint.restore_train_state(tmp_path / "ck", tcfg,
                                                     device="cpu")
    assert step == 5 and int(state["step"]) == 1
    want = convert.flat_from_jax(jp, tcfg)
    for name, p in lm.named_parameters():
        _same(want[name], p.detach())
    for key in ("m", "v"):
        want = convert.flat_from_jax(js[key], tcfg)
        for name, t in state[key].items():
            _same(want[name], t)


@pytest.mark.parametrize("arch", ["qwen3_14b", "recurrentgemma_2b"])
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    cfg, lm, state = _trained(arch, steps=2)
    checkpoint.save_train_state(tmp_path / "ck", lm, state, cfg, step=2)
    jp = jmodel.init_params(jconfigs.get_reduced(arch), KEY)
    like = jax.eval_shape(lambda: {"params": jp,
                                   "opt": jadamw.adamw_init(jp)})
    tree, step = jrestore(tmp_path / "ck", like)
    assert step == 2 and int(tree["opt"]["step"]) == 2
    want = {"params": convert.params_to_jax(lm, cfg),
            "opt": convert.opt_state_to_jax(state, cfg)}
    got_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_opt_state_carrier_round_trip():
    cfg, lm, state = _trained("granite_moe_1b_a400m")
    back = convert.opt_state_from_jax(convert.opt_state_to_jax(state, cfg),
                                      cfg, device="cpu")
    for key in ("m", "v"):
        assert set(back[key]) == set(state[key])
        for name, t in state[key].items():
            assert torch.equal(t, back[key][name])
    assert torch.equal(back["step"], state["step"])


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("model=", "step "))]


def test_cli_train_prints_jax_lines(capsys, monkeypatch):
    """``cli train --reduced --steps 2 --device cpu`` prints JAX's lines:
    the same model line (the same parameter count) and one step line a
    step in JAX's format (the weights are not JAX's, so the values
    differ)."""
    cli.main(["train", "--reduced", "--steps", "2", "--batch", "2",
              "--seq", "16", "--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    from repro.launch import cli as jcli
    monkeypatch.setattr("sys.argv", ["cli", "train", "--reduced", "--steps",
                                     "2", "--batch", "2", "--seq", "16"])
    jcli.main()
    want = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    assert got[0] == want[0]
    pattern = re.compile(r"step +(\d+) loss=\d+\.\d{4} gnorm=\d+\.\d{3} "
                         r"\(\d+\.\ds\)")
    for g, w in zip(got[1:], want[1:]):
        assert pattern.fullmatch(g) and pattern.fullmatch(w)
        assert pattern.fullmatch(g).group(1) == pattern.fullmatch(w).group(1)


def test_cli_dryrun_writes_a_record_and_skips_it_after(tmp_path, capsys,
                                                      monkeypatch):
    """``cli dryrun`` runs ``launch.dryrun.main`` in this process (reduced
    configs by the registry patched, meta tensors, no card): a record with
    JAX's keys and ``ok: true``, and a second call skips the file."""
    import repro_torch.configs as tconfigs
    monkeypatch.setattr(tconfigs, "get", tconfigs.get_reduced)
    args = ["dryrun", "--arch", "qwen3-14b", "--shape", "decode_32k",
            "--mesh", "single", "--out", str(tmp_path)]
    cli.main(args)
    assert "all dry-runs OK" in capsys.readouterr().out
    rec = json.loads((tmp_path / "qwen3_14b__decode_32k__single.json")
                     .read_text())
    assert rec["ok"] and rec["chips"] == 256
    assert {"arch", "shape", "mesh", "variant", "chips", "ok", "lower_s",
            "compile_s", "memory_analysis", "cost_analysis",
            "collective_bytes", "collective_bytes_raw", "roofline",
            "comm_bytes"} <= set(rec)
    cli.main(args)
    assert "[skip existing] qwen3_14b__decode_32k__single" in \
        capsys.readouterr().out
