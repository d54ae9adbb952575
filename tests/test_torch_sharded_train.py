"""Torch port, the sharded train step on the CPU.

``launch.train.make_jitted_train_step`` at one rank against the port's
``make_train_step``, then across gloo groups of 2 and 4 ranks
(``repro_torch.launch.ranks.spawn``; workers in ``tests/_torch_ranks.py``,
no jax) against JAX's ``make_train_step`` for one step from the same
JAX-initialised weights and global batch: reduced qwen3, mamba2 and
granite-moe (dense route, and the scatter route with its rows split over
"data" at (2, 1) and over both axes at (2, 2): ROADMAP Queue 1 item
13.7) in fp32 on meshes (2, 1), (1, 2) and (2, 2),
``fsdp=False``, a batch whose rows do not divide the mesh (every rank
takes every row), one that divides only "data", and the "dots" remat
policy across the ranks.  Loss, gnorm, every whole weight after the step
and each rank's block of both moments within 1e-5 (fp32 summed in other
orders).  The labels mask a different number of positions in each row,
so a mean of per-rank means would miss the global mean.  Both groups
start together in threads; JAX's references are computed while they
run."""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as tr
import repro.configs as jconfigs
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
import repro_torch.configs as tconfigs
from repro_torch.data.synthetic import token_stream
from repro_torch.launch import mesh as M
from repro_torch.launch import ranks as tranks
from repro_torch.launch import sharding as shd
from repro_torch.launch import train
from repro_torch.models import convert, model
from repro_torch.optim import AdamWConfig, adamw_init
from _torch_cases import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
S = 16
LR = 1e-3
# fp32 on both sides, summed in other orders (XLA on the CPU vs torch,
# whole products vs per-rank shares reduced across ranks)
TOL = 1e-5

# key: (arch, (data, model), rows, fsdp, config overrides)
CASES = {
    "qwen3 2x1": ("qwen3_14b", (2, 1), 2, True, {}),
    "qwen3 1x2": ("qwen3_14b", (1, 2), 2, True, {}),
    "mamba2 2x1": ("mamba2_370m", (2, 1), 2, True, {}),
    "granite 1x2": ("granite_moe_1b_a400m", (1, 2), 2, True, {}),
    "qwen3 2x2": ("qwen3_14b", (2, 2), 4, True, {}),
    "qwen3 2x2 fsdp=False": ("qwen3_14b", (2, 2), 4, False, {}),
    "qwen3 2x2 rows 3": ("qwen3_14b", (2, 2), 3, True, {}),
    "qwen3 2x2 rows 2": ("qwen3_14b", (2, 2), 2, True, {}),
    "mamba2 2x2": ("mamba2_370m", (2, 2), 4, True, {}),
    "granite 2x2": ("granite_moe_1b_a400m", (2, 2), 4, True, {}),
    # glm4-9b's bias and partial-RoPE leaves under ZeRO-3
    "glm4 2x2": ("glm4_9b", (2, 2), 4, True, {}),
    "qwen3 2x2 dots": ("qwen3_14b", (2, 2), 4, True,
                       {"remat_policy": "dots"}),
    # the scatter route with its rows split: global capacity and slots
    "granite scatter 2x1": ("granite_moe_1b_a400m", (2, 1), 2, True,
                            {"moe_routing": "scatter"}),
    "granite scatter 2x2": ("granite_moe_1b_a400m", (2, 2), 4, True,
                            {"moe_routing": "scatter"}),
}
SCATTER = [k for k, c in CASES.items() if c[4].get("moe_routing") == "scatter"]
# recurrentgemma at 3 layers of a (rec, attn) pattern: layer 2 is a tail
# layer
INIT = {"qwen3_14b": ((2, 1), {}),
        "recurrentgemma_2b": ((1, 2), {"num_layers": 3})}


def _cfgs(arch, over):
    return (dataclasses.replace(jconfigs.get_reduced(arch),
                                param_dtype="float32", **over),
            dataclasses.replace(tconfigs.get_reduced(arch),
                                param_dtype="float32", **over))


def _batch(cfg, rows, seed):
    """A global batch from the synthetic stream (bit-equal in both
    packages), each row with its own count of masked labels."""
    b = next(token_stream(cfg, rows, S, seed=seed, device="cpu"))
    b = {k: v.numpy().copy() for k, v in b.items()}
    for r in range(rows):
        b["labels"][r, :3 * r] = -1
    return b


def _tree(jp):
    return jax.tree.map(lambda a: np.asarray(a), jp)


def _case(key, spec):
    arch, shape, rows, fsdp, over = spec
    jcfg, _ = _cfgs(arch, over)
    return dict(arch=arch, shape=shape, fsdp=fsdp, lr=LR, cfg=over,
                tree=_tree(jmodel.init_params(jcfg, KEY)),
                batch=_batch(jcfg, rows, seed=len(key)))


def _reference(case):
    jcfg, _ = _cfgs(case["arch"], case["cfg"])
    jp = jmodel.init_params(jcfg, KEY)
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(lr=LR),
                                     total_steps=10))
    jp, js, jm = jstep(jp, jadamw_init(jp),
                       {k: jnp.asarray(v) for k, v in case["batch"].items()})
    return jp, js, jm


@pytest.fixture(scope="module")
def runs():
    cases = {k: _case(k, v) for k, v in CASES.items()}
    by_size = {}
    for key, c in cases.items():
        by_size.setdefault(c["shape"][0] * c["shape"][1], {})[key] = c
    pool = concurrent.futures.ThreadPoolExecutor(len(by_size) + 1)
    futs = {k: pool.submit(tranks.spawn, tr.sharded_train, k, (group,),
                           device="cpu", deadline_s=400.0, timeout_s=200.0)
            for k, group in by_size.items()}
    futs["init"] = pool.submit(
        lambda: {arch: tranks.spawn(tr.init_blocks, 2,
                                    (arch, INIT[arch][0], 5, INIT[arch][1]),
                                    device="cpu", deadline_s=200.0)
                 for arch in INIT})
    futs["check"] = pool.submit(_check_ranks)
    refs = {k: _reference(c) for k, c in cases.items()}
    yield cases, futs, refs
    pool.shutdown(wait=True)


def _check_ranks():
    """``chip_smoke.py`` phase 19's rank check (``train.check_rank``) on
    four gloo ranks of the CPU, reduced qwen3-14b in bf16 as configured,
    against the one-rank step saved as the phase saves it."""
    import tempfile
    cfg = tconfigs.get_reduced("qwen3_14b")
    batch = next(token_stream(cfg, 4, S, seed=3, device="cpu"))
    lm = model.init_params(cfg, seed=0, device="cpu", trainable=True)
    state = adamw_init(lm)
    lm, state, m = train.make_train_step(cfg, AdamWConfig(lr=1e-2),
                                         total_steps=10)(lm, state, batch)
    with tempfile.TemporaryDirectory() as ref_dir:
        torch.save({n: p.detach() for n, p in lm.named_parameters()},
                   f"{ref_dir}/params.pt")
        for key in ("m", "v"):
            torch.save(state[key], f"{ref_dir}/{key}.pt")
        recs = tranks.spawn(train.check_rank, 4, (
            cfg, (2, 2), batch, 1e-2, 0, ref_dir, "cpu"), device="cpu",
            deadline_s=300.0)
    return m, recs


def _rank_block(a, spec, shape, rank):
    """Rank ``rank``'s block of a whole array on the (data, model) mesh of
    ``shape`` (row-major coordinates)."""
    coords = {"data": rank // shape[1], "model": rank % shape[1]}
    sizes = dict(zip(("data", "model"), shape))
    for d, ax in enumerate(spec):
        if ax is not None:
            k = a.shape[d] // sizes[ax]
            a = np.take(a, np.arange(coords[ax] * k, (coords[ax] + 1) * k),
                        axis=d)
    return a


def _results(runs, key):
    cases, futs, refs = runs
    c = cases[key]
    k = c["shape"][0] * c["shape"][1]
    return c, [out[key] for out in futs[k].result(timeout=600)], refs.get(key)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_step_matches_jax(runs, key):
    """Every rank returns the same loss and gnorm, JAX's within 1e-5; the
    whole weights after the step and each rank's moment blocks are JAX's
    within 1e-5; the specs the step returns are ``param_pspecs``'."""
    c, outs, (jp, js, jm) = _results(runs, key)
    _, tcfg = _cfgs(c["arch"], c["cfg"])
    for o in outs:
        assert o["metrics"] == outs[0]["metrics"], key
        assert o["step"] == 1
    got = outs[0]["metrics"]
    assert abs(got["loss"] - float(jm["loss"])) <= TOL, (got, jm)
    assert abs(got["gnorm"] - float(jm["gnorm"])) <= TOL * max(
        1.0, float(jm["gnorm"])), (got, jm)
    want = convert.flat_from_jax(jp, tcfg)
    for o in outs:
        assert set(o["params"]) == set(want)
        for name, p in o["params"].items():
            dev = np.abs(p.numpy() - np.asarray(want[name])).max()
            assert dev <= TOL, (key, name, dev)
    mesh = M.abstract_mesh(c["shape"], ("data", "model"))
    p_specs, o_specs, _ = outs[0]["specs"]
    abstract = model.abstract_params(tcfg)
    assert p_specs == shd.param_pspecs(abstract, mesh, fsdp=c["fsdp"])
    assert o_specs["m"] == o_specs["v"] == shd.param_pspecs(abstract, mesh)
    for moment in ("m", "v"):
        whole = convert.flat_from_jax(js[moment], tcfg)
        for r, o in enumerate(outs):
            for name, blk in o[moment].items():
                w = _rank_block(np.asarray(whole[name]), o_specs["m"][name],
                                c["shape"], r)
                assert blk.shape == w.shape, (name, blk.shape, w.shape)
                dev = np.abs(blk.numpy() - w).max()
                assert dev <= TOL, (key, moment, name, r, dev)


def test_scatter_route_under_a_row_split_raises(runs):
    """The MoE scatter route's capacity and slot order depend on the
    global T.  Until ROADMAP Queue 1 item 13.7 the step raised under a
    row split; now it raises no longer: each case runs with its rows
    split (``row_axes``) on every rank, each rank slotting its tokens in
    global order (JAX's numbers: ``test_sharded_step_matches_jax``)."""
    cases, futs, _ = runs
    for key in SCATTER:
        c = cases[key]
        mesh = M.abstract_mesh(c["shape"], ("data", "model"))
        assert train.row_axes(len(c["batch"]["tokens"]), mesh)
        for out in futs[c["shape"][0] * c["shape"][1]].result(timeout=600):
            assert "error" not in out[key], out[key]
            assert out[key]["step"] == 1


@pytest.mark.parametrize("arch", list(INIT))
def test_init_sharded_keeps_blocks_of_init_params(runs, arch):
    """Each rank's blocks are the blocks of exactly the weights
    ``model.init_params(cfg, seed)`` draws (bf16), and ``gather_params``
    gives them whole on every rank; recurrentgemma's tail layers take
    their 2-D weights' dim 0 whole."""
    outs = runs[1]["init"].result(timeout=600)[arch]
    shape, over = INIT[arch]
    cfg = tconfigs.get_reduced(arch, **over)
    ref = {n: p.detach() for n, p in model.init_params(
        cfg, seed=5, device="cpu").named_parameters()}
    for r, o in enumerate(outs):
        assert set(o["whole"]) == set(ref)
        for name, w in ref.items():
            assert torch.equal(o["whole"][name], w), name
            blk = _rank_block(w.float().numpy(), o["specs"][name], shape, r)
            assert np.array_equal(o["blocks"][name].float().numpy(), blk)
    if arch == "recurrentgemma_2b":
        # the tail layer's 2-D weights keep dim 0 whole, its 1-D leaves
        # split theirs on "model"; the pattern layers' 2-D weights split
        # dim 1 on "model" (data is 1)
        tail = f"layers.{cfg.num_layers - 1}."
        two = [n for n in o["specs"] if n.startswith(tail) and ref[n].ndim == 2]
        one = [n for n in o["specs"] if n.startswith(tail) and ref[n].ndim == 1]
        assert two and all(o["specs"][n][0] is None for n in two)
        assert one and all(o["specs"][n] == ("model",) for n in one
                           if ref[n].shape[0] % 2 == 0)


@pytest.mark.parametrize("arch", ["qwen3_14b", "mamba2_370m",
                                  "granite_moe_1b_a400m"])
def test_sharded_step_at_one_rank_matches_make_train_step(arch):
    """On a mesh of one rank (no group) the sharded step is the one-rank
    step: two steps from the same weights and batches, loss, gnorm,
    weights and moments within 1e-5."""
    _, cfg = _cfgs(arch, {})
    mesh = M.make_host_mesh()
    ref = model.init_params(cfg, seed=2, device="cpu", trainable=True)
    state = adamw_init(ref)
    lm = shd.init_sharded(cfg, mesh, seed=2, device="cpu")
    ostate = shd.init_opt_state(cfg, mesh, "cpu")
    one = train.make_train_step(cfg, AdamWConfig(lr=LR), total_steps=10)
    step, _ = train.make_jitted_train_step(cfg, AdamWConfig(lr=LR), mesh,
                                           _batch(cfg, 2, 0), total_steps=10)
    for i in range(2):
        b = _batch(cfg, 2, i)
        _, state, m1 = one(ref, state, b)
        with M.bound(mesh):
            _, ostate, m2 = step(lm, ostate, b)
        for k in ("loss", "gnorm"):
            assert abs(float(m1[k]) - float(m2[k])) <= TOL
    whole = shd.gather_params(lm)
    for name, p in ref.named_parameters():
        assert (whole[name] - p).abs().max() <= TOL, name
        for moment in ("m", "v"):
            assert (ostate[moment][name] - state[moment][name]).abs().max() \
                <= TOL, (moment, name)


def test_row_axes_and_the_reported_layout():
    """The rows split over every axis, data first, where that divides
    them; else over the data axes; else none.  ``batch_pspecs`` keeps
    JAX's rule (data axes only)."""
    mesh = M.abstract_mesh((2, 2), ("data", "model"))
    assert train.row_axes(4, mesh) == ("data", "model")
    assert train.row_axes(8, mesh) == ("data", "model")
    assert train.row_axes(2, mesh) == ("data",)
    assert train.row_axes(6, mesh) == ("data",)
    assert train.row_axes(3, mesh) == ()
    pod = M.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert train.row_axes(8, pod) == ("pod", "data", "model")
    assert train.row_axes(4, pod) == ("pod", "data")
    assert shd.batch_pspecs({"tokens": (4, 16)}, pod)["tokens"] == \
        M.P(("pod", "data"))
    assert train.row_axes(5, M.abstract_mesh((1, 1), ("data", "model"))) \
        == ()


def test_gather_binds_its_mesh_in_autograds_thread():
    """On the card autograd runs the backward (and remat's recompute) on a
    thread of its own, outside the caller's ``bound``: a sharded model's
    backward run from another thread than its forward still reaches the
    mesh (here a mesh of one rank, whose gathers name axes of size 1)."""
    import threading
    _, cfg = _cfgs("granite_moe_1b_a400m", {})
    mesh = M.make_host_mesh()
    lm = shd.init_sharded(cfg, mesh, seed=0, device="cpu")
    errors = []

    def run(loss):
        try:
            loss.backward()
        except Exception as err:      # noqa: BLE001 - reported below
            errors.append(err)
    with M.bound(mesh), train.moe.rows_split(
            train.functools.partial(train._psum, mesh, ("data",))):
        loss = model.loss_fn(lm, _batch(cfg, 2, 0), cfg)
        t = threading.Thread(target=run, args=(loss,))
        t.start()
        t.join()
    assert not errors, errors
    assert all(p.grad is not None for n, p in shd.blocks(lm).items()
               if "ln2" not in n)


def test_phase_19_rank_check_against_the_one_rank_step(runs):
    """``train.check_rank`` (``chip_smoke.py`` phase 19) on four gloo
    ranks: every rank's loss and gnorm are the one-rank step's, and its
    weight and moment blocks read within the phase's bf16 limits."""
    import chip_smoke
    m, recs = runs[1]["check"].result(timeout=600)
    for r in recs:
        assert abs(r["loss"] - float(m["loss"])) <= chip_smoke.SHARD_TOL[
            "loss"]
        assert abs(r["gnorm"] - float(m["gnorm"])) <= chip_smoke.SHARD_TOL[
            "gnorm"] * float(m["gnorm"])
        for key in ("params", "m", "v"):
            assert r[key]["leaves"] == len(dict(model.abstract_params(
                tconfigs.get_reduced("qwen3_14b")).named_parameters()))
            assert r[key]["max"] <= chip_smoke.SHARD_TOL[key], (key, r[key])


def test_train_loop_across_ranks_holds_the_losses_equal(capsys):
    """``train_loop`` over two gloo ranks of the CPU (mesh (1, 2)), as the
    four-card command line runs it: every rank's losses equal, finite, and
    said so on the losses line."""
    cfg = tconfigs.get_reduced("glm4_9b")
    recs, losses = train.train_loop(cfg, steps=2, batch=2, seq=16,
                                    device="cpu", ranks=2, mesh=(1, 2))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(r["losses"] == losses for r in recs)
    assert "(equal on every rank)" in capsys.readouterr().out
