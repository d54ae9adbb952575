"""Dry runs: one rank's step of every (architecture x input shape x mesh)
combination on ``torch.device("meta")``, with the roofline inputs of an
H100 (memory, FLOPs, bytes, collective bytes).

Counterpart of ``repro.launch.dryrun``, which lowers and compiles JAX's
jitted steps against a TPU mesh of 16 x 16 (or 2 x 16 x 16) placeholder
devices and reads XLA's analyses.  The port has no XLA: its dry run
executes the step itself, eagerly, on meta tensors — nothing holds data,
nothing runs on a card, so this is the one entry point that needs no card
(and no ``torch.distributed`` group).  It is the same code path the card
takes: the port's own steps (``launch.train.make_jitted_train_step``,
ZeRO-3; ``launch.serve.make_jitted_serve_step``, tensor-parallel decode;
prefill, the ZeRO-3 forward under no grad and an argmax, as JAX's
``prefill``) at one rank's blocks, with the mesh bound by ``mesh.dry``
to one virtual rank of an ``AbstractMesh`` of JAX's sizes: every
collective returns a tensor of its result's shape, recorded and never
sent, and every kernel takes its meta route (``kernels.ops``): the
instance an H100 would run, its scratch allocated, its flops and bytes
counted (``kernels.cost``).

What the record holds, key for key JAX's, and how each is read:

  - ``memory_analysis``: ``argument_bytes``, the bytes of this rank's
    blocks of the step's arguments that the step reads (XLA drops the
    arguments a program does not use, and so does this count: a decode
    step reads no encoder weight); ``temp_bytes``, the peak of the bytes
    allocated during the step and alive at once (a ``TorchDispatchMode``
    adds each op's new storage and a ``weakref.finalize`` on the storage
    takes it off: autograd's saved tensors, each leaf's gathered weight
    a use and the kernels' scratch are counted while they live);
    ``output_bytes``, the step's results; ``peak_bytes`` = argument +
    temp, as JAX's.
  - ``cost_analysis``: ``flops`` by ``torch.utils.flop_counter``'s
    formulas (``FlopCounterMode``'s) plus the kernels' counts; ``bytes_accessed`` the sum of each dispatched op's
    input and output bytes (views and allocations read nothing) plus the
    kernels' counted bytes — an unfused count, not XLA's, whose fusions
    read and write less.  The eager meta run executes every layer, so
    there is no scan body to correct for: ``flops_raw`` equals ``flops``
    and ``scan_correction_flops`` is 0.
  - ``collective_bytes``: the step's collectives under XLA's HLO names
    and sized by their results, as JAX's ``collective_bytes`` reads its
    HLO — but they are the port's own collectives, not GSPMD's: ZeRO-3
    gathers and reduce-scatters in the train step, the tensor-parallel
    decode's gathers and sums.  ``comm_bytes`` adds the port's own
    sizing, equal to what ``mesh.comm_bytes`` records for the same step
    on a real group.  The serve step's one-off gather of the small leaves
    (``serve.serve_leaves``, on its first call) is listed apart, under
    ``leaf_gather_bytes``: JAX's compiled step has no such one-off.
  - ``roofline``: at an H100 SXM's data-sheet peaks at its 700 W power
    limit (``PEAK_FLOPS`` bf16 dense, ``HBM_BW``, ``LINK_BW`` NVLink each
    way).  At 16 x 16 a real cluster crosses hosts over a slower network
    than NVLink, so ``collective_s`` is a lower bound there.

``mesh_kind`` "single" and "multi" are JAX's 16 x 16 ("data", "model")
and 2 x 16 x 16 ("pod", "data", "model"), as ``AbstractMesh``es; the
tests and ``chip_smoke.py`` pass a mesh and an ``InputShape`` of their
own.  The variants are JAX's list, with JAX's knobs.  ``attnshard`` and
``seqpar`` read as baseline: the port's ``shardctx.constrain`` is the
identity.  The decode shapes read ``zero1`` and ``ep`` as baseline, as
JAX's serve step takes neither.  A combination the port refuses gets a
record with ``ok: false`` and the error, as JAX's ``main`` records a
failure; ``main --jobs N`` runs N combinations at once, each in a process
of its own.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape decode_32k --mesh single --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

import repro_torch.configs as configs
from repro_torch.data.synthetic import SHAPES, InputShape, input_specs
from repro_torch.kernels import cost
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd

# --- H100 SXM constants (roofline denominators; NVIDIA data sheet, 700 W) ---
CARD = "NVIDIA H100 SXM (data sheet, 700 W)"
LINK = "NVLink 4, 450 GB/s each way"
PEAK_FLOPS = cost.PEAK_BF16      # bf16 dense FLOP/s per card
HBM_BW = cost.PEAK_BYTES         # bytes/s per card
LINK_BW = cost.LINK_BYTES        # bytes/s per card each way

VARIANTS = ("baseline", "zero1", "ep", "zero1_ep", "scatter", "ep_scatter",
            "rematdots", "rematdots_ep", "attnshard", "seqpar", "seqpar_ep",
            "rematnames", "seqpar_rematnames", "kv8")

# ops that allocate and read nothing
_ALLOCATING = {torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided}


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_tensors(args, kwargs, out):
    """The tensors an op takes (its arguments, and the lists among them)
    and those it returns."""
    ins = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            ins.append(a)
        elif isinstance(a, (list, tuple)):
            ins += [t for t in a if isinstance(t, torch.Tensor)]
    if isinstance(out, torch.Tensor):
        return ins, [out]
    if isinstance(out, (list, tuple)):
        return ins, [t for t in out if isinstance(t, torch.Tensor)]
    return ins, []


class Accounting(TorchDispatchMode):
    """Counts, for the ops dispatched inside it: the bytes of the storages
    they allocate that are alive at once (their peak), the bytes they read
    and write, their flops (``torch.utils.flop_counter``'s formulas, as
    ``FlopCounterMode`` counts them: the matrix products, convolutions and
    attention), and which of the ``arguments`` they read.  Storage is
    followed by its identity, each new one freed by a ``weakref.finalize``.
    A collective's result carries the arguments of its operand
    (``moved``), so a weight gathered from its block counts as a read of
    the block when an op reads the gathered weight.  ``start`` opens the
    step: what was allocated before it is not counted."""

    def __init__(self, arguments):
        super().__init__()
        self.owner: Dict[int, set] = {}
        for i, t in enumerate(arguments):
            self.owner.setdefault(_key(t), set()).add(i)
        self.used: set = set()
        self.counting = False
        self._live: Dict[int, int] = {}
        self.live = self.peak = 0
        self.bytes = self.flops = 0

    def start(self):
        self._live.clear()
        self.live = self.peak = self.bytes = self.flops = 0
        self.used.clear()
        self.counting = True

    def _free(self, key: int, nbytes: int):
        if self._live.pop(key, None) is not None:
            self.live -= nbytes

    def _alloc(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self.owner:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def read(self, t: torch.Tensor):
        """A kernel's meta route reads ``t`` (``cost.read_hook``)."""
        if self.counting:
            self.used.update(self.owner.get(_key(t), ()))

    def moved(self, x: torch.Tensor, out: torch.Tensor):
        """``out`` holds ``x``'s data (a collective's result)."""
        src = self.owner.get(_key(x))
        if src:
            st = out.untyped_storage()
            self.owner.setdefault(st._cdata, set()).update(src)
            weakref.finalize(st, self.owner.pop, st._cdata, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.counting:
            return out
        ins, outs = _op_tensors(args, kwargs, out)
        in_keys = {_key(t) for t in ins}
        packet = func.overloadpacket
        if not func.is_view and packet not in _ALLOCATING:
            for key in in_keys:
                src = self.owner.get(key)
                if src:
                    self.used.update(src)
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
            count = flop_registry.get(packet)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            if _key(t) not in in_keys:
                self._alloc(t)
        return out


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _distinct_bytes(tree) -> int:
    seen, total = set(), 0
    for t in _tensors(tree):
        key = _key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


@dataclasses.dataclass
class Measured:
    """What ``measure`` read of one call: the ``Accounting`` counts, the
    flops, the kernels' counts and the collectives by call."""
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    flops: float
    bytes_accessed: float
    kernel_counts: dict
    calls: list
    wall_s: float


def measure(fn, arguments, block_bytes, rec: M.DryRecord, before=None):
    """Run ``fn()`` once under ``Accounting``: ``arguments`` are the
    step's argument tensors and ``block_bytes`` the bytes of this rank's
    block of each (a global batch leaf is passed whole; the step takes its
    rows).  ``before()`` runs first, counted apart: the calls it makes are
    not the step's (the serve step's one-off gather of the small
    leaves)."""
    acc = Accounting(arguments)
    rec.moved, cost.read_hook[0] = acc.moved, acc.read
    cost.reset()
    t0 = time.perf_counter()
    try:
        with acc:
            if before is not None:
                before()
            first = len(rec.calls)
            acc.start()
            out = fn()
            out_bytes = _distinct_bytes(out)
    finally:
        rec.moved = cost.read_hook[0] = None
    kf, kb = cost.totals()
    return Measured(
        argument_bytes=sum(block_bytes[i] for i in sorted(acc.used)),
        output_bytes=out_bytes, temp_bytes=acc.peak,
        flops=float(acc.flops) + kf,
        bytes_accessed=float(acc.bytes) + kb,
        kernel_counts={k: dict(v) for k, v in cost.counts.items()},
        calls=rec.calls[first:], wall_s=time.perf_counter() - t0)


def _mode_for(cfg, shape_name: str) -> str:
    if shape_name == "long_500k":
        return "long"
    return {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode"}[shape_name]


def production_mesh(mesh_kind: str) -> M.AbstractMesh:
    """JAX's production mesh as a description: 16 x 16 ("data", "model"),
    or 2 x 16 x 16 ("pod", "data", "model") for ``"multi"``."""
    if mesh_kind == "multi":
        return M.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return M.abstract_mesh((16, 16), ("data", "model"))


def variant_config(cfg, variant: str):
    """``cfg`` with JAX's variant knobs (``run_one``)."""
    over = {}
    if "scatter" in variant:
        over["moe_routing"] = "scatter"
    if "rematdots" in variant:
        over["remat_policy"] = "dots"
    if "rematnames" in variant:
        over["remat_policy"] = "names"
    if "attnshard" in variant:
        over["attn_act_shard"] = True
    if "seqpar" in variant:
        over["seq_parallel"] = True
    if "kv8" in variant:
        over["kv_cache_dtype"] = "int8"
    return dataclasses.replace(cfg, **over) if over else cfg


def _batch_args(batch, mesh):
    """(tensors, block bytes) of a global batch under ``batch_pspecs``."""
    specs = shd.batch_pspecs(batch, mesh)
    tensors = list(batch.values())
    sizes = [_nbytes(shd.block_shape(t.shape, specs[k], mesh), t.dtype)
             for k, t in batch.items()]
    return tensors, sizes


def _param_args(lm):
    blocks = list(shd.blocks(lm).values())
    return blocks, [b.numel() * b.element_size() for b in blocks]


def train_step_call(cfg, mesh, sh: InputShape, mode: str, fsdp: bool,
                    ep: bool):
    """(the call, its arguments, their block bytes, None) of one sharded
    train step on meta (``dry_step``)."""
    from repro_torch.launch.train import make_jitted_train_step
    from repro_torch.optim import AdamWConfig
    batch = input_specs(cfg, sh)
    step, _ = make_jitted_train_step(cfg, AdamWConfig(), mesh, batch,
                                     mode=mode, fsdp=fsdp,
                                     expert_parallel=ep)
    params = shd.abstract_sharded(cfg, mesh, fsdp=fsdp, expert_parallel=ep)
    opt = shd.init_opt_state(cfg, mesh, "meta", expert_parallel=ep)
    p_args, p_sizes = _param_args(params)
    o_args = list(opt["m"].values()) + list(opt["v"].values()) + [
        opt["step"]]
    b_args, b_sizes = _batch_args(batch, mesh)
    return (lambda: step(params, opt, batch), p_args + o_args + b_args,
            p_sizes + [t.numel() * t.element_size() for t in o_args]
            + b_sizes, None)


def prefill_call(cfg, mesh, sh: InputShape, mode: str, fsdp: bool, ep: bool):
    """(the call, its arguments, their block bytes, None) of one prefill:
    the ZeRO-3 forward of the train step under no grad, rows split by
    ``train.row_axes``, then the argmax over the logits (JAX's
    ``prefill``)."""
    import functools

    from repro_torch.launch.train import _gather, _psum, row_axes
    from repro_torch.launch.mesh import P
    from repro_torch.models import model, moe
    batch = input_specs(cfg, sh)
    params = shd.abstract_sharded(cfg, mesh, fsdp=fsdp, expert_parallel=ep,
                                  trainable=False)

    def prefill():
        rows = len(batch["tokens"])
        axes = row_axes(rows, mesh)
        with M.bound(mesh), torch.no_grad():
            local = {k: M.block(v, P(axes)) if axes and len(v) == rows
                     else v for k, v in batch.items()}
            split = (moe.rows_split(functools.partial(_psum, mesh, axes),
                                    functools.partial(_gather, mesh, axes),
                                    M.axis_index(axes))
                     if axes else contextlib.nullcontext())
            with split:
                logits, _ = model.forward(params, local, cfg, mode=mode)
            return torch.argmax(logits, dim=-1)

    p_args, p_sizes = _param_args(params)
    b_args, b_sizes = _batch_args(batch, mesh)
    return prefill, p_args + b_args, p_sizes + b_sizes, None


def serve_step_call(cfg, mesh, sh: InputShape, mode: str, fsdp: bool,
                    ep: bool):
    """(the call, its arguments, their block bytes, the one-off gather of
    the small leaves) of one sharded decode step on meta: the weights'
    ``fsdp=False`` blocks, the cache's blocks, the token and the
    position.  ``fsdp`` and ``ep`` go unused, as JAX's decode takes
    neither."""
    from repro_torch.launch import serve
    B, S = sh.global_batch, sh.seq_len
    step, _ = serve.make_jitted_serve_step(cfg, mesh, B, S, mode=mode)
    params = shd.abstract_sharded(cfg, mesh, fsdp=False, trainable=False)
    cache = shd.init_cache_blocks(cfg, mesh, B, S, mode, device="meta")
    spec = serve.token_spec(mesh, B)
    token = torch.empty((B,), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    p_args, p_sizes = _param_args(params)
    c_args = _tensors(cache)
    return (lambda: step(params, cache, token, pos),
            p_args + c_args + [token, pos],
            p_sizes + [t.numel() * t.element_size() for t in c_args]
            + [_nbytes(shd.block_shape((B,), spec, mesh), torch.int32), 4],
            lambda: serve.serve_leaves(params, mesh))


def dry_step(cfg, mesh, sh: InputShape, mode: str, *, fsdp: bool = True,
             ep: bool = False, rank: int = 0):
    """One rank's step of ``sh``'s kind on ``mesh`` (any mesh description)
    on meta: (``Measured``, the one-off calls before it)."""
    with M.dry(mesh, rank) as rec:
        call = {"train": train_step_call, "prefill": prefill_call,
                "decode": serve_step_call}[sh.kind]
        fn, args, sizes, before = call(cfg, mesh, sh, mode, fsdp, ep)
        got = measure(fn, args, sizes, rec, before)
        once = rec.calls[:len(rec.calls) - len(got.calls)]
    return got, once


def roofline(flops: float, bytes_acc: float, coll_total: float):
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_acc / HBM_BW,
             "collective_s": coll_total / LINK_BW}
    return terms, max(terms, key=terms.get)


def model_flops(cfg, sh: InputShape) -> float:
    """JAX's model flops of one step: 6·N·tokens to train, 2·N·tokens
    else (N: the active parameters of a MoE)."""
    n_model = cfg.active_params() if cfg.arch_type == "moe" \
        else cfg.n_params()
    tokens = (sh.global_batch * sh.seq_len if sh.kind != "decode"
              else sh.global_batch)
    return (6.0 if sh.kind == "train" else 2.0) * n_model * tokens


def run_one(arch, shape_name, mesh_kind, verbose: bool = True,
            variant: str = "baseline", rank: int = 0):
    """One rank's dry run of one (arch, shape, mesh) combination; returns
    JAX's record, with ``comm_bytes`` (the port's sizing) and
    ``leaf_gather_bytes`` (the serve step's one-off) besides.

    ``arch``: a registry name or a config; ``shape_name``: a name of
    ``SHAPES`` or an ``InputShape``; ``mesh_kind``: "single", "multi" or
    a mesh description (``mesh.abstract_mesh``).  ``variant``: JAX's
    (module docstring)."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    name = arch if isinstance(arch, str) else cfg.name
    cfg = variant_config(cfg, variant)
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = (production_mesh(mesh_kind) if isinstance(mesh_kind, str)
            else mesh_kind)
    kind = (mesh_kind if isinstance(mesh_kind, str)
            else "x".join(str(n) for _, n in mesh.axes))
    mode = _mode_for(cfg, sh.name) if sh.name in SHAPES else (
        "train" if sh.kind == "train" else
        "prefill" if sh.kind == "prefill" else "decode")
    fsdp = "zero1" not in variant
    ep = "ep" in variant.split("_")
    got, once = dry_step(cfg, mesh, sh, mode, fsdp=fsdp, ep=ep, rank=rank)
    coll = M.DryRecord.hlo_of(got.calls)
    terms, dominant = roofline(got.flops, got.bytes_accessed, coll["total"])
    n_chips = mesh.size
    mflops = model_flops(cfg, sh)
    rec = {
        "arch": name, "shape": sh.name, "mesh": kind, "variant": variant,
        "chips": int(n_chips), "ok": True,
        "lower_s": 0.0, "compile_s": round(got.wall_s, 2),
        "memory_analysis": {
            "argument_bytes": got.argument_bytes,
            "output_bytes": got.output_bytes,
            "temp_bytes": got.temp_bytes,
            "peak_bytes": got.temp_bytes + got.argument_bytes,
        },
        "cost_analysis": {"flops": got.flops,
                          "bytes_accessed": got.bytes_accessed,
                          "flops_raw": got.flops,
                          "bytes_raw": got.bytes_accessed,
                          "scan_correction_flops": 0.0},
        "collective_bytes": coll,
        "collective_bytes_raw": dict(coll),
        "comm_bytes": M.DryRecord.comm_of(got.calls),
        "leaf_gather_bytes": M.DryRecord.comm_of(once),
        "kernels": got.kernel_counts,
        "roofline": {**terms, "dominant": dominant,
                     "model_flops_total": mflops,
                     "hlo_flops_per_chip": got.flops,
                     "useful_flops_ratio": (mflops / (got.flops * n_chips)
                                            if got.flops else 0.0),
                     "card": CARD, "link": LINK},
    }
    if verbose:
        print(f"[{name} x {sh.name} x {kind}] dry={got.wall_s:.1f}s "
              f"mem(temp)={got.temp_bytes} flops/chip={got.flops:.3e} "
              f"bytes/chip={got.bytes_accessed:.3e} "
              f"coll={coll['total']:.3e}B dominant={dominant}", flush=True)
    return rec


def _run_key(job):
    """``run_one`` of one combination in a worker of ``main --jobs``:
    (the record, the error's text or None)."""
    arch, shape, mesh_kind, variant = job
    try:
        return run_one(arch, shape, mesh_kind, variant=variant), None
    except Exception as e:  # noqa: BLE001 — record and continue
        return ({"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "variant": variant, "ok": False, "error": repr(e)},
                traceback.format_exc())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations run at once, each in a process of "
                         "its own (the runs share nothing)")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list(configs.ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    jobs = {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = f"{configs.ALIASES.get(arch, arch)}__{shape}__{mesh_kind}"
                if args.variant != "baseline":
                    key += f"__{args.variant}"
                if (outdir / f"{key}.json").exists():
                    print(f"[skip existing] {key}")
                    continue
                jobs[key] = (arch, shape, mesh_kind, args.variant)
    if args.jobs > 1 and len(jobs) > 1:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            done = dict(zip(jobs, pool.map(_run_key, jobs.values())))
    else:
        done = {key: _run_key(job) for key, job in jobs.items()}
    failures = []
    for key, (rec, err) in done.items():
        if err is not None:
            print(err, file=sys.stderr)
            failures.append(key)
        (outdir / f"{key}.json").write_text(json.dumps(rec, indent=1))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("all dry-runs OK")


if __name__ == "__main__":
    main()
