"""Torch port, the dry runs on the CPU.

``launch.dryrun`` and ``launch.dryrun_decsvm`` run one rank's step on
meta tensors against JAX's production meshes (``mesh.dry``: a virtual
rank of a 16 x 16 or 2 x 16 x 16 ``AbstractMesh``, no group), every
kernel on its meta route.  They are held exactly:

  - to JAX's records where the two packages agree.  JAX's side runs in
    two subprocesses started together (``JAX_PLATFORMS=cpu``, JSON on
    stdout; the JAX package unchanged): ``repro.launch.dryrun.run_one``
    with ``repro.configs.get`` bound to ``get_reduced`` for the decode
    and long shapes, and ``repro.launch.dryrun_decsvm.run_one`` at (256,
    16, 127) on both schedules; for ``train_4k`` and ``prefill_32k``,
    which JAX's ``run_one`` refuses on this jax (explicit mesh axes),
    JAX's specs (``param_pspecs``, ``batch_pspecs``, as
    ``tests/test_torch_sharding.py`` builds them) applied to the
    ``jax.eval_shape`` structs of ``init_params``, ``adamw_init`` and
    ``input_specs``, over the arguments that JAX keeps: its jaxpr's dead
    code removed (``pe.dce_jaxpr``, the rule by which ``jax.jit`` drops an
    unused argument), as XLA's argument bytes count them.  Argument
    bytes, model flops, ``_mode_for``, the ADMM round's collectives;
  - to the port's own real steps where they differ by design from JAX's
    (ZeRO-3 and the tensor-parallel decode, not GSPMD): the dry
    ``comm_bytes`` against ``mesh.comm_bytes`` of the same step on a gloo
    group of 4 ranks (``tests/_torch_ranks.py``: ``sharded_train``,
    ``sharded_serve``, ``admm_comm``; started after JAX's subprocesses
    end, so that the module never runs more than four processes of its
    own at once), every rank;
  - each kernel's meta route: the plain version's output shapes and
    dtypes, the card's instance, no launch, and its flops and bytes
    reproducing the bounds of ``PERF.md`` §6 (the counts that
    ``chip_smoke.py``'s bounds read).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks as tr
import repro_torch.configs as tconfigs
from repro_torch.data.synthetic import SHAPES, InputShape, token_stream
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun, dryrun_decsvm
from repro_torch.launch import mesh as M
from repro_torch.launch import ranks as tranks
from repro_torch.models import convert, model
from _torch_cases import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
DECODE = [("qwen3-14b", "decode_32k", "single"),
          ("qwen3-14b", "decode_32k", "multi"),
          ("qwen3-14b", "long_500k", "single"),
          ("mamba2-370m", "decode_32k", "single"),
          ("granite-moe-3b-a800m", "decode_32k", "single"),
          ("seamless-m4t-large-v2", "decode_32k", "single")]
# JAX's records of these combinations (jax 0.9.0, reduced configs): the
# oracle's subprocess reads them again below
DECODE_BYTES = {DECODE[0]: 33915300, DECODE[1]: 17138068,
                DECODE[2]: 885128, DECODE[3]: 314008, DECODE[4]: 33890660,
                DECODE[5]: 68092836}
ADMM = {"gather": (9800, {"all-gather": 262144, "total": 262144}),
        "ring": (8776, {"collective-permute": 2048, "total": 2048})}
SPEC_SHAPES = ("train_4k", "prefill_32k")

_JAX_DRYRUN = r"""
import json, sys
from pathlib import Path
import repro.launch.dryrun as D
import repro.launch.dryrun_decsvm as DD
import repro.configs as configs
full = configs.get
configs.get = configs.get_reduced
out = {"lm": {}, "admm": {}, "modes": {}, "n_model": {}}
for arch, shape, mesh in json.loads(sys.argv[2]):
    rec = D.run_one(arch, shape, mesh, verbose=False)
    out["lm"][f"{arch}/{shape}/{mesh}"] = dict(
        argument_bytes=rec["memory_analysis"]["argument_bytes"],
        model_flops_total=rec["roofline"]["model_flops_total"])
for s in ("gather", "ring"):
    rec = DD.run_one(256, 16, 127, s, False, Path(sys.argv[1]))
    out["admm"][s] = dict(
        argument_bytes=rec["memory_analysis"]["argument_bytes"],
        collective_bytes=rec["collective_bytes"])
out["modes"] = {s: D._mode_for(None, s) for s in D.SHAPES}
for arch in configs.ARCHS:
    cfg = full(arch)
    out["n_model"][arch] = (cfg.active_params() if cfg.arch_type == "moe"
                            else cfg.n_params())
print(json.dumps(out))
"""

_JAX_SPECS = r"""
import functools, json, math, sys
import jax, jax.numpy as jnp
from jax.sharding import AbstractMesh, PartitionSpec
from jax._src.interpreters import partial_eval as pe
import repro.configs as configs
from repro.data.synthetic import SHAPES, input_specs
from repro.launch import sharding as shd
from repro.launch.train import make_train_step
from repro.models import model
from repro.optim import AdamWConfig, adamw_init

def block_bytes(leaf, spec, mesh):
    shape = list(leaf.shape)
    for d, ax in enumerate(tuple(spec)):
        if ax is not None:
            names = (ax,) if isinstance(ax, str) else tuple(ax)
            shape[d] //= math.prod(mesh.shape[a] for a in names)
    return math.prod(shape) * jnp.dtype(leaf.dtype).itemsize

def kept_bytes(arch, shape, kind):
    cfg = configs.get_reduced(arch)
    mesh = (AbstractMesh((16, 16), ("data", "model")) if kind == "single"
            else AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    sh = SHAPES[shape]
    params = jax.eval_shape(functools.partial(model.init_params, cfg),
                            jax.random.PRNGKey(0))
    batch = input_specs(cfg, sh)
    p_specs = shd.param_pspecs(params, mesh)
    b_specs = shd.batch_pspecs(batch, mesh)
    if sh.kind == "train":
        opt = jax.eval_shape(adamw_init, params)
        fn = make_train_step(cfg, AdamWConfig())
        args = (params, opt, batch)
        specs = (p_specs, {"m": p_specs, "v": p_specs,
                           "step": PartitionSpec()}, b_specs)
    else:
        def fn(params, batch):
            logits, _ = model.forward(params, batch, cfg, mode="prefill")
            return jnp.argmax(logits, axis=-1)
        args, specs = (params, batch), (p_specs, b_specs)
    closed = jax.make_jaxpr(fn)(*args)
    _, used = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    leaves = jax.tree_util.tree_leaves(args)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves) == len(used)
    return sum(block_bytes(a, s, mesh)
               for a, s, u in zip(leaves, spec_leaves, used) if u)

print(json.dumps({f"{a}/{s}/{k}": kept_bytes(a, s, k)
                  for a in configs.ARCHS for s in json.loads(sys.argv[2])
                  for k in ("single", "multi")}))
"""


def _start(script, tmp, arg):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", script, str(tmp),
                             json.dumps(arg)], env=env, cwd=str(tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _json(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


# the real steps on a gloo group of 4 (fp32, reduced): the train step on
# (2, 2), the serve step on (1, 4) and (2, 2), a dense and an MoE config,
# and the ADMM round on both schedules, one node a rank
TRAIN = {"qwen3 2x2": ("qwen3_14b", (2, 2), 4)}
SERVE = {f"{name} {d}x{m}": (arch, (d, m))
         for name, arch in (("qwen3", "qwen3_14b"),
                            ("granite", "granite_moe_1b_a400m"))
         for d, m in ((1, 4), (2, 2))}
ADMM_REAL = {"gather": 3, "ring": 3}
S, ROWS, MAX_LEN, PROMPT = 16, 4, 16, 2
ADMM_SHAPE = (4, 16, 8)


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_reduced(arch),
                               param_dtype="float32")


def _tree(arch, seed):
    """A JAX-layout tree (numpy) of the port's init, no JAX needed."""
    cfg = _cfg(arch)
    return convert.params_to_jax(model.init_params(cfg, seed=seed,
                                                   device="cpu"), cfg)


def _real_cases():
    train = {}
    for key, (arch, shape, rows) in TRAIN.items():
        b = next(token_stream(_cfg(arch), rows, S, seed=1, device="cpu"))
        train[key] = dict(arch=arch, shape=shape, fsdp=True, lr=1e-3,
                          tree=_tree(arch, 0),
                          batch={k: v.numpy().copy() for k, v in b.items()})
    rng = np.random.default_rng(0)
    serve = {key: dict(arch=arch, shape=shape, cfg={}, steps=2,
                       max_len=MAX_LEN, offsets=None, tree=_tree(arch, 1),
                       prompt=rng.integers(0, 500, (ROWS, PROMPT)),
                       enc_media=None)
             for key, (arch, shape) in SERVE.items()}
    m, n, p = ADMM_SHAPE
    W = np.roll(np.eye(m, dtype=np.float32), 1, 1)
    W = W + W.T
    admm = {s: dict(schedule=s, max_iter=r, W=W,
                    X=rng.standard_normal((m, n, p)).astype(np.float32),
                    y=np.sign(rng.standard_normal((m, n))).astype(
                        np.float32))
            for s, r in ADMM_REAL.items()}
    return train, serve, admm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_dryrun")
    procs = {"dryrun": _start(_JAX_DRYRUN, tmp, DECODE),
             "specs": _start(_JAX_SPECS, tmp, SPEC_SHAPES)}
    try:
        out = {k: _json(p) for k, p in procs.items()}
        out["real"] = tranks.spawn(tr.dry_cases, 4, _real_cases(),
                                   device="cpu", deadline_s=300.0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture
def reduced(monkeypatch):
    """``configs.get`` bound to ``get_reduced``, as JAX's side is."""
    monkeypatch.setattr(tconfigs, "get", tconfigs.get_reduced)


@pytest.mark.parametrize("case", DECODE, ids=["/".join(c) for c in DECODE])
def test_decode_argument_bytes_equal_jax(runs, reduced, case):
    want = runs["dryrun"]["lm"]["/".join(case)]
    assert want["argument_bytes"] == DECODE_BYTES[case]
    rec = dryrun.run_one(*case, verbose=False)
    assert rec["ok"]
    assert rec["memory_analysis"]["argument_bytes"] == want["argument_bytes"]
    assert rec["roofline"]["model_flops_total"] == want["model_flops_total"]
    # the step's keys are JAX's, with the port's sizing besides
    assert {"memory_analysis", "cost_analysis", "collective_bytes",
            "collective_bytes_raw", "roofline", "comm_bytes"} <= set(rec)
    assert rec["cost_analysis"]["flops_raw"] == rec["cost_analysis"]["flops"]
    assert rec["cost_analysis"]["scan_correction_flops"] == 0.0


@pytest.mark.parametrize("shape", SPEC_SHAPES)
@pytest.mark.parametrize("kind", ("single", "multi"))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_train_prefill_argument_bytes_equal_jax_specs(runs, reduced, arch,
                                                      shape, kind):
    rec = dryrun.run_one(arch, shape, kind, verbose=False)
    assert rec["memory_analysis"]["argument_bytes"] == \
        runs["specs"][f"{arch}/{shape}/{kind}"]


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_model_flops_and_mode_match_jax(runs, arch):
    n_model = runs["dryrun"]["n_model"][arch]
    cfg = tconfigs.get(arch)
    for name, sh in SHAPES.items():
        tokens = (sh.global_batch * sh.seq_len if sh.kind != "decode"
                  else sh.global_batch)
        want = (6.0 if sh.kind == "train" else 2.0) * n_model * tokens
        assert dryrun.model_flops(cfg, sh) == want
        assert dryrun._mode_for(cfg, name) == runs["dryrun"]["modes"][name]


@pytest.mark.parametrize("schedule", ("gather", "ring"))
def test_decsvm_matches_jax(runs, tmp_path, schedule):
    want = runs["dryrun"]["admm"][schedule]
    assert (want["argument_bytes"], want["collective_bytes"]) == \
        ADMM[schedule]
    rec = dryrun_decsvm.run_one(256, 16, 127, schedule, False, tmp_path)
    assert rec["memory_analysis"]["argument_bytes"] == want["argument_bytes"]
    assert rec["collective_bytes"] == want["collective_bytes"]
    assert json.loads((tmp_path / f"decsvm_admm__m256_n16_p127_{schedule}"
                       "__single.json").read_text())["ok"]
    # the port's final gather of B (JAX's out_specs keep B sharded)
    assert rec["final_gather_bytes"]["hlo"] == {"all-gather": 256 * 128 * 4,
                                                "total": 256 * 128 * 4}
    assert rec["backend"] == "jnp"


def test_decsvm_kernel_backend_takes_the_two_pass_meta_route(tmp_path):
    rec = dryrun_decsvm.run_one(256, 16, 127, "gather", False, tmp_path,
                                backend="megakernel")
    k = rec["kernels"]["csvm_block_update"]
    assert k["calls"] == 1.0
    assert (k["flops"], k["bytes"]) == cost.two_pass_work(1, 16, 128, 4)
    assert rec["memory_analysis"]["argument_bytes"] == 9800


def _comm(d):
    return {k: v for k, v in d.items() if v}


@pytest.mark.parametrize("key", list(TRAIN))
def test_dry_train_comm_bytes_equal_real_step(runs, key):
    arch, shape, rows = TRAIN[key]
    mesh = M.abstract_mesh(shape, ("data", "model"))
    for rank, real in enumerate(runs["real"]):
        rec = dryrun.run_one(_cfg(arch), InputShape("t", S, rows, "train"),
                             mesh, verbose=False, rank=rank)
        assert rec["comm_bytes"] == _comm(real["train"][key]["comm_bytes"])


@pytest.mark.parametrize("key", list(SERVE))
def test_dry_serve_comm_bytes_equal_real_step(runs, key):
    arch, shape = SERVE[key]
    mesh = M.abstract_mesh(shape, ("data", "model"))
    for rank, real in enumerate(runs["real"]):
        first, steady = real["serve"][key]["comm_bytes"]
        rec = dryrun.run_one(_cfg(arch),
                             InputShape("d", MAX_LEN, ROWS, "decode"), mesh,
                             verbose=False, rank=rank)
        assert rec["comm_bytes"] == _comm(steady)
        # the first step gathers the small leaves once besides
        once = {op: rec["leaf_gather_bytes"].get(op, 0)
                + rec["comm_bytes"].get(op, 0) for op in first}
        assert once == first


@pytest.mark.parametrize("schedule", list(ADMM_REAL))
def test_dry_admm_comm_bytes_equal_real_fit(runs, schedule):
    from repro_torch.core.admm import ADMMConfig
    m, n, p = ADMM_SHAPE
    mesh = M.abstract_mesh((m,), ("node",))
    cfg = ADMMConfig(lam=0.01, h=0.1, max_iter=ADMM_REAL[schedule])
    for rank, real in enumerate(runs["real"]):
        got = dryrun_decsvm.dry_fit(m, n, p - 1, cfg, mesh, schedule, rank)
        assert M.DryRecord.comm_of(got.calls) == real["admm"][schedule]


# --------------------------------------------------------------------------
# The mesh's dry binding
# --------------------------------------------------------------------------


def test_dry_binding_resolves_a_virtual_rank():
    mesh = M.abstract_mesh((16, 16), ("data", "model"))
    with pytest.raises(ValueError):
        M._make((16, 16), ("data", "model"))      # no group of 256 ranks
    with M.dry(mesh, rank=37) as rec:
        assert (M.rank(), M.device_count()) == (37, 256)
        with M.bound(mesh):
            assert M.axis_index("data") == 2 and M.axis_index("model") == 5
            assert M.axis_size(("data", "model")) == 256
            x = torch.empty((4, 3), device="meta")
            blk = M.block(torch.empty((32, 16), device="meta"),
                          M.P("data", "model"))
            assert tuple(blk.shape) == (2, 1)
            assert tuple(M.collective("all_gather", x, "model").shape) == \
                (64, 3)
            assert tuple(M.collective("psum_scatter", torch.empty(
                (32, 3), device="meta"), "data").shape) == (2, 3)
            for op in ("psum", "pmax", "pmean", "ppermute"):
                y = M.collective(op, x, "data", perm=[(0, 1)])
                assert y.shape == x.shape and y.is_meta
            assert M.collective("psum", x, ()) is x
    assert M.DryRecord.comm_of(rec.calls) == {
        "all_gather": 64 * 3 * 4, "psum_scatter": 32 * 3 * 4,
        "psum": 48, "pmax": 48, "pmean": 48, "ppermute": 48}
    assert M.DryRecord.hlo_of(rec.calls) == {
        "all-gather": 64 * 3 * 4, "reduce-scatter": 2 * 3 * 4,
        "all-reduce": 3 * 48, "collective-permute": 48,
        "total": 64 * 12 + 24 + 4 * 48}
    # outside the dry run, nothing changes
    assert (M.rank(), M.device_count()) == (0, 1)
    with pytest.raises(ValueError):
        M.dry(mesh, rank=256).__enter__()


@pytest.mark.parametrize("arch", ("mamba2_370m", "recurrentgemma_2b"))
def test_hybrid_and_ssm_cache_at_model_axis_1_and_3(arch):
    """JAX's ``cache_pspecs`` names "model" twice for these caches (ROADMAP
    caveats), so JAX cannot dry-run them at a model axis of 1 or 3; the
    port's step reads only axes above 1: it runs at 1 and refuses the conv
    cache's W - 1 = 3 split on "model" at 3."""
    cfg = tconfigs.get_reduced(arch)
    sh = InputShape("d", 64, 12, "decode")
    rec = dryrun.run_one(cfg, sh, M.abstract_mesh((4, 1), ("data", "model")),
                         verbose=False)
    assert rec["ok"] and rec["memory_analysis"]["argument_bytes"] > 0
    with pytest.raises(NotImplementedError, match="conv"):
        dryrun.run_one(cfg, sh, M.abstract_mesh((1, 3), ("data", "model")),
                       verbose=False)


def test_main_writes_skips_and_reports_failures(tmp_path, reduced, capsys,
                                                monkeypatch):
    args = ["--arch", "qwen3-14b", "--shape", "decode_32k", "--mesh",
            "both", "--out", str(tmp_path)]
    dryrun.main(args)
    assert "all dry-runs OK" in capsys.readouterr().out
    recs = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in recs] == ["qwen3_14b__decode_32k__multi.json",
                                      "qwen3_14b__decode_32k__single.json"]
    assert all(json.loads(p.read_text())["ok"] for p in recs)
    dryrun.main(args)
    assert capsys.readouterr().out.count("[skip existing]") == 2

    def refuse(*a, **k):
        raise NotImplementedError("refused")
    monkeypatch.setattr(dryrun, "run_one", refuse)
    with pytest.raises(SystemExit) as err:
        dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert err.value.code == 1
    assert "FAILURES" in capsys.readouterr().out
    bad = json.loads((tmp_path / "qwen3_14b__train_4k__single.json")
                     .read_text())
    assert not bad["ok"] and "refused" in bad["error"]


# --------------------------------------------------------------------------
# The kernels' meta routes
# --------------------------------------------------------------------------


def _meta(tree):
    return [t.to("meta") if isinstance(t, torch.Tensor) else t for t in tree]


def _no_launch(monkeypatch):
    """Every kernel library refuses: a meta tensor must never reach one."""
    def refuse():
        raise AssertionError("a kernel library was loaded")
    for lib in ("_lib", "_flash_lib", "_flash_backward_lib", "_ssd_lib",
                "_ssd_backward_lib"):
        monkeypatch.setattr(ops, lib, refuse)
    ops.reset_launches()
    cost.reset()


def _same_layout(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


def _csvm_operands(m=3, n=16, p=24):
    rng = np.random.default_rng(0)

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    X = f(m, n, p)
    y = torch.sign(f(m, n))
    return X, y, f(m, p), f(m, p), f(m, m), f(m).abs(), f(m).abs() + 1.0, \
        f(m).abs(), f(p).abs()


KERNEL_CASES = ("csvm_round_block", "csvm_block_update", "csvm_local_update",
                "flash_attention", "flash_attention_backward", "ssd_scan",
                "ssd_scan_backward")


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_meta_route(monkeypatch, name):
    X, y, B, P, W, deg, rho, omega, lam = _csvm_operands()
    q = torch.randn(1, 4, 32, 64).to(torch.bfloat16)
    k = torch.randn(1, 2, 32, 64).to(torch.bfloat16)
    x = torch.randn(1, 32, 4, 16).to(torch.bfloat16)
    dt = torch.rand(1, 32, 4)
    A = -torch.rand(4)
    Bs = torch.randn(1, 32, 16).to(torch.bfloat16)
    calls = {
        "csvm_round_block": (lambda *a: ops.csvm_round_block(
            *a, tau=1.0, lam0=0.0, h=0.3, num_rounds=2, want_kkt=True),
            (X, y, B, P, W, deg, rho, omega, lam,
             torch.tensor(2, dtype=torch.int32)), "stream"),
        "csvm_block_update": (lambda *a: ops.csvm_block_update(*a, h=0.3),
                              (X, y, B, P, B, rho, omega, lam), "stream"),
        "csvm_local_update": (lambda *a: ops.csvm_local_update(*a, h=0.3),
                              (X, y, B, P, B, rho, omega, lam), "stream"),
        "flash_attention": (lambda *a: ops.flash_attention(*a, causal=True),
                            (q, k, k), "wgmma"),
        "flash_attention_backward": (
            lambda *a: ops.flash_attention_backward(*a, causal=True),
            (q, k, k, q, q), "wgmma"),
        "ssd_scan": (lambda *a: ops.ssd_scan(*a, chunk=64),
                     (x, dt, A, Bs, Bs, A), "wgmma"),
        "ssd_scan_backward": (lambda *a: ops.ssd_scan_backward(*a, chunk=64),
                              (x, dt, A, Bs, Bs, A, x), "wgmma"),
    }
    fn, args, instance = calls[name]
    want = fn(*args)                              # the plain version
    _no_launch(monkeypatch)
    got = fn(*_meta(args))
    _same_layout(got, want)
    assert cost.counts[name]["calls"] == 1
    assert cost.counts[name]["instances"] == {instance: 1}
    assert not any(ops.launches.values())


def _ms(name, itemsize=2):
    c = cost.counts[name]
    peak = cost.PEAK_BF16 if itemsize == 2 else cost.PEAK_FP32
    return 1e3 * max(c["flops"] / peak,
                     c["bytes"] / cost.PEAK_BYTES)


def test_meta_counts_reproduce_the_bounds(monkeypatch):
    """The meta routes' counts at ``PERF.md`` §6's shapes give its bounds
    (H100 peaks), and ``chip_smoke.py``'s bounds read the same count."""
    import chip_smoke
    bf = torch.bfloat16
    _no_launch(monkeypatch)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    ops.flash_attention(meta(1, 40, 2048, 128, dtype=bf),
                        meta(1, 8, 2048, 128, dtype=bf),
                        meta(1, 8, 2048, 128, dtype=bf), causal=True)
    assert round(_ms("flash_attention"), 4) == 0.0434
    assert _ms("flash_attention") == chip_smoke.attention_bound(
        1, 40, 8, 2048, 128, 2)[0]
    q = meta(2, 40, 4096, 128, dtype=bf)
    kv = meta(2, 8, 4096, 128, dtype=bf)
    ops.flash_attention_backward(q, kv, kv, q, q, causal=True)
    assert round(_ms("flash_attention_backward"), 4) == 0.8688
    assert _ms("flash_attention_backward") == chip_smoke.backward_bound(
        (2, 40, 8, 4096, 4096, 128, True, None))[0][0]
    b, s, h, p, n = 1, 2048, 32, 64, 128
    ops.ssd_scan(meta(b, s, h, p, dtype=bf), meta(b, s, h), meta(h),
                 meta(b, s, n, dtype=bf), meta(b, s, n, dtype=bf), meta(h),
                 chunk=64)
    assert round(_ms("ssd_scan"), 4) == 0.0057
    assert _ms("ssd_scan") == chip_smoke.ssd_bound(b, s, h, p, n, 64, 2)[0]
    b = 8
    x = meta(b, s, h, p, dtype=bf)
    ops.ssd_scan_backward(x, meta(b, s, h), meta(h), meta(b, s, n, dtype=bf),
                          meta(b, s, n, dtype=bf), meta(h), x, chunk=64)
    assert round(_ms("ssd_scan_backward"), 4) == 0.0664
    assert _ms("ssd_scan_backward") == chip_smoke.ssd_backward_bound(
        b, s, h, p, n, 64, 2, dfinal=False)[0]
    m, n, p = 16, 1024, 4096
    X = meta(m, n, p)
    rows = (meta(m, n), meta(m, p), meta(m, p))
    ops.csvm_block_update(X, *rows, meta(m, p), meta(m), meta(m), meta(p),
                          h=0.3)
    assert round(_ms("csvm_block_update", 4), 4) == 0.0805
    ops.csvm_round_block(X, *rows, meta(m, m), meta(m), meta(m), meta(m),
                         meta(p), meta(dtype=torch.int32), tau=1.0,
                         lam0=0.0, h=0.3, num_rounds=300)
    assert round(_ms("csvm_round_block", 4), 4) == 1.2019
    assert not any(ops.launches.values())


def test_models_take_the_kernel_route_on_meta(monkeypatch):
    """On meta the model's attention and SSD branches take the card's
    route (the kernels' meta routes), not the plain versions."""
    _no_launch(monkeypatch)
    for arch, name in (("qwen3_14b", "flash_attention"),
                       ("mamba2_370m", "ssd_scan")):
        cfg = tconfigs.get_reduced(arch)
        lm = model.abstract_params(cfg)
        tokens = torch.empty((2, 64), dtype=torch.int32, device="meta")
        logits, _ = model.forward(lm, {"tokens": tokens}, cfg, mode="prefill")
        assert logits.is_meta and logits.shape == (2, 64, cfg.padded_vocab)
        assert cost.counts[name]["calls"] == cfg.num_layers
    assert not any(ops.launches.values())


@pytest.mark.parametrize("dtype,instance", [("bfloat16", "wgmma"),
                                            ("float32", "fma")])
def test_hybrid_train_step_at_head_dim_256_takes_the_card_instance(
        dtype, instance):
    """recurrentgemma's train step at its head dim (the reduced config
    with head_dim 256, 5 layers, a window of 16 under S = 64), dry-run on
    a (1, 1) mesh: every attention layer's flash forward (the pass and its
    remat) and backward recorded on the instance the card runs — the
    tensor-core one in bf16, the fp32-FMA one in fp32 — each with the
    work ``kernels/cost.py`` counts for its shape, whatever the
    instance."""
    from repro_torch.data.synthetic import InputShape
    cfg = dataclasses.replace(
        tconfigs.get_reduced("recurrentgemma_2b", num_layers=5,
                             head_dim=256), sliding_window=16,
        param_dtype=dtype)
    B, S, attn = 2, 64, 2
    rec = dryrun.run_one(cfg, InputShape("train", S, B, "train"),
                         M.abstract_mesh((1, 1), ("data", "model")),
                         verbose=False)
    fwd = rec["kernels"]["flash_attention"]
    bwd = rec["kernels"]["flash_attention_backward"]
    assert fwd["instances"] == {instance: 2 * attn}
    assert bwd["instances"] == {instance: attn}
    isz = 2 if dtype == "bfloat16" else 4
    H, KV = cfg.num_heads, cfg.num_kv_heads
    flops, nbytes = cost.attention_work(B, H, KV, S, 256, isz, 16, S, True)
    assert (fwd["flops"], fwd["bytes"]) == (2 * attn * flops,
                                            2 * attn * nbytes)
    flops, nbytes, _ = cost.attention_backward_work(B, H, KV, S, S, 256,
                                                    True, 16, isz)
    assert (bwd["flops"], bwd["bytes"]) == (attn * flops, attn * nbytes)
    assert not any(ops.launches.values())


def test_phase22_rehearsal_on_the_cpu():
    """``chip_smoke.py`` phase 22 on the CPU at the reduced configs: the
    dry runs of the training and decode steps against the same steps run
    once (argument bytes equal to the inputs'), the four-card predictions,
    and ``dryrun.main`` in processes of its own."""
    import chip_smoke
    rec = chip_smoke.dryrun_phase(torch, ops, device="cpu", reduced=True)
    for kind in ("train", "decode"):
        assert rec[kind]["argument_bytes"] == rec[kind]["input_bytes"]
        assert not any(rec[kind]["launches"].values())
    assert rec["train"]["kernels"]["flash_attention"]["calls"] == 8
    assert rec["all"] == dict(rc=0, records=2, failures=[],
                              wall_s=rec["all"]["wall_s"])
    assert [r["comm_bytes"] for r in rec["four_card"]][1:3] == [
        {"psum": 57600, "all_gather": 49152, "pmax": 256},
        {"psum": 28800, "all_gather": 24576, "pmax": 128}]
    # the four-card runs of phases 27-28's configurations predicted too
    assert [(r["kind"], r["arch"], r["mesh"]) for r in rec["four_card"]][3:] \
        == [("train", "glm4_9b", [2, 2]), ("decode", "command_r_35b", [1, 4]),
            ("decode", "command_r_35b", [2, 2])]
    assert all(r["peak_bytes"] > 0 for r in rec["four_card"])
