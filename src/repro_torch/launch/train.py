"""Training: the train step, its sharded form over a mesh of ranks, and
(run as a script) training on synthetic data.

Counterpart of ``repro.launch.train``.  ``make_train_step`` returns the
eager step: ``model.loss_fn``, its gradient by autograd (on the card the
attention's through the ``flash_attention_backward`` kernel and mamba2's
SSD scan through the ``ssd_scan_backward`` kernel, so every family trains
there; each layer recomputed under ``torch.utils.checkpoint``), then
``adamw_update`` in place at ``cosine_schedule(step, total_steps,
warmup=20)``, as JAX's.

``make_jitted_train_step`` shards the step over a mesh of the
``torch.distributed`` group, with JAX's placements
(``launch.sharding``): each weight and moment lives as blocks on the
ranks, and the step returns JAX's (step, (p_specs, o_specs, b_specs)).
The compute is a declared difference from JAX's, where GSPMD derives it
from the placements: the port computes ZeRO-3 style.  Each rank runs
``model.loss_terms`` on its share of the global batch's rows (split over
every axis of the mesh, data axes first, where that divides the rows;
else over the data axes; else every rank takes every row), each layer's
weights all-gathered from their blocks before it runs and again when
remat recomputes it; each whole-layer gradient is reduce-scattered back
to the blocks in fp32 and cast once; AdamW's arithmetic then runs on the
blocks.  The loss is the global mean: each rank's sum of masked cross
entropy over the global count, summed over the ranks; MoE's aux loss
sums the router's counts over the ranks first, and its scatter route
slots the tokens in global order (``moe.rows_split``); ranks that
computed the same rows average their gradients; ``gnorm``
counts each block once.  No family's model code changes for it.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    python3 -m repro_torch.launch.train --ranks 4 --mesh 2x2 \\
        --arch qwen3-14b --full --batch 4 --seq 4096 --steps 10
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import math
import os
import statistics
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.admm import resolve_device
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import P
from repro_torch.models import model, moe
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)

def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    total_steps: int = 1000, mode: str = "train"):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm"}); ``params`` (a trainable ``LM``) and the moments
    are updated in place."""
    def train_step(params, opt_state, batch):
        params.zero_grad(set_to_none=True)
        loss = model.loss_fn(params, batch, cfg, mode=mode)
        loss.backward()
        grads = {name: p.grad for name, p in params.named_parameters()}
        lr_scale = cosine_schedule(opt_state["step"], total_steps, warmup=20)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg, lr_scale)
        params.zero_grad(set_to_none=True)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}

    return train_step


def row_axes(rows: int, mesh) -> Tuple[str, ...]:
    """The axes that split a batch of ``rows`` rows in the sharded step:
    every axis of the mesh, data axes first, where their product divides
    ``rows``; else the data axes where theirs does; else none."""
    data = M.data_axes(mesh)
    every = data + tuple(a for a in mesh.axis_names if a not in data)
    for axes in (every, data):
        n = math.prod(mesh.shape[a] for a in axes)
        if n > 1 and rows % n == 0:
            return axes
    return ()


def sharded_norm(specs, mesh):
    """grads -> their global fp32 norm, where each rank holds the blocks of
    ``specs``: a block's sum of squares is summed over the axes its spec
    names (the ranks that hold distinct blocks), once for each set of
    axes, and not over the axes it is replicated along."""
    def norm(grads):
        sums: Dict[tuple, torch.Tensor] = {}
        for name, g in grads.items():
            if g is None:
                continue
            named = set(shd.spec_axes(specs[name]))
            axes = tuple(a for a in mesh.axis_names
                         if a in named and mesh.shape[a] > 1)
            sq = torch.sum(torch.square(g.to(torch.float32)))
            sums[axes] = sq if axes not in sums else sums[axes] + sq
        total = None
        for axes, sq in sums.items():
            if axes:
                sq = M.collective("psum", sq, axes)
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    return norm


def _data_dims(p_spec: P, m_spec: P):
    """The dims a moment block splits on "data" and its weight's block
    (``fsdp=False``) does not."""
    return [d for d, (a, b) in enumerate(zip(m_spec, p_spec))
            if a is not None and b is None]


def _moment_view(t, dims):
    """The part of a weight's block (a view) that the moment block of
    this rank covers."""
    for d in dims:
        k = t.shape[d] // M.axis_size("data")
        t = t.narrow(d, M.axis_index("data") * k, k)
    return t


def _psum(mesh, axes, t):
    """``t`` summed over ``axes`` of ``mesh``, bound here: remat's
    recompute calls it from autograd's own thread on the card."""
    with M.bound(mesh):
        return M.collective("psum", t, axes)


def _gather(mesh, axes, t):
    """The ranks' ``t`` along ``axes`` of ``mesh`` concatenated on dim 0,
    bound here as ``_psum`` is."""
    with M.bound(mesh):
        return M.collective("all_gather", t, axes)


def make_jitted_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                           batch_struct, total_steps: int = 1000,
                           mode: str = "train", fsdp: bool = True,
                           expert_parallel: bool = False):
    """The step over ``mesh`` (module docstring), and JAX's specs: returns
    (step, (p_specs, o_specs, b_specs)).  ``o_specs`` holds the moments
    under the ``fsdp=True`` specs for both values of ``fsdp`` (JAX's
    ZeRO-1 layout when ``fsdp=False``: weights on "model" only) and
    ``"step"`` replicated; ``b_specs`` is ``batch_pspecs(batch_struct)``.

    ``step(params, opt_state, batch)`` is called on every rank: ``params``
    a sharded model (``sharding.init_sharded`` / ``shard_params`` under the
    same ``fsdp`` and ``expert_parallel``), ``opt_state`` the moments'
    blocks (``sharding.init_opt_state``), ``batch`` the global batch.  It
    updates the blocks in place and returns (params, opt_state, {"loss",
    "gnorm"}), equal on every rank.  With ``fsdp=False`` a rank updates
    the part of its weight block that its moment block covers, then
    all-gathers the weight block along "data"."""
    abstract = model.abstract_params(cfg)
    p_specs = shd.param_pspecs(abstract, mesh, fsdp=fsdp,
                               expert_parallel=expert_parallel)
    m_specs = shd.param_pspecs(abstract, mesh, fsdp=True,
                               expert_parallel=expert_parallel)
    o_specs = {"m": m_specs, "v": m_specs, "step": P()}
    b_specs = shd.batch_pspecs(batch_struct, mesh)
    del abstract
    norm = sharded_norm(m_specs, mesh)
    dims = {name: _data_dims(p_specs[name], m_specs[name])
            for name in p_specs}

    def step(params, opt_state, batch):
        rows = len(batch["tokens"])
        axes = row_axes(rows, mesh)
        rep = mesh.size // math.prod(mesh.shape[a] for a in axes)
        with M.bound(mesh):
            local = {k: M.block(v, P(axes)) if axes and len(v) == rows else v
                     for k, v in batch.items()}
            params.zero_grad(set_to_none=True)
            split = (moe.rows_split(functools.partial(_psum, mesh, axes),
                                    functools.partial(_gather, mesh, axes),
                                    M.axis_index(axes))
                     if axes else contextlib.nullcontext())
            with split:
                ce_sum, count, aux = model.loss_terms(params, local, cfg,
                                                      mode=mode)
                if axes:
                    count = M.collective("psum", count.detach(), axes)
                share = (ce_sum / torch.clamp(count, min=1.0)
                         + model.AUX_WEIGHT * aux)
                (share / rep).backward()
            loss = share.detach()
            if axes:
                loss = M.collective("psum", loss, axes)
            blocks = shd.blocks(params)
            grads = {name: p.grad for name, p in blocks.items()}
            if not fsdp:
                blocks = {n: _moment_view(b, dims[n]) for n, b in blocks.items()}
                grads = {n: None if g is None else _moment_view(g, dims[n])
                         for n, g in grads.items()}
            lr_scale = cosine_schedule(opt_state["step"], total_steps,
                                       warmup=20)
            _, opt_state, gnorm = adamw_update(blocks, grads, opt_state,
                                               opt_cfg, lr_scale, norm=norm)
            if not fsdp:
                with torch.no_grad():
                    for name, part in blocks.items():
                        if dims[name]:
                            spec = P(*["data" if d in dims[name] else None
                                       for d in range(part.ndim)])
                            whole = shd.blocks(params)[name]
                            whole.copy_(M.assemble(part, spec))
            params.zero_grad(set_to_none=True)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    return step, (p_specs, o_specs, b_specs)


def train_loop(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
               lr: float = 3e-4, log_every: int = 10, seed: int = 0,
               device="cuda", ranks: int = 1, mesh=None):
    """End-to-end training on synthetic bigram data (``token_stream``),
    printing JAX's lines; on the card unless ``device="cpu"``.  Returns
    (params, losses).

    With ``ranks`` > 1 (or a ``mesh``: its (data, model) sizes, (ranks, 1)
    by default) the sharded step trains on ``ranks`` processes of one
    group (``launch.ranks.spawn``: NCCL with a card a rank, else gloo),
    each from ``sharding.init_sharded``'s blocks of the same seed's
    weights and the same global batches; rank 0 prints JAX's lines, then
    the parent a line a rank (``rank_line``).  Returns (the ranks'
    records, losses)."""
    if ranks > 1 or mesh is not None:
        return _train_ranks(cfg, steps=steps, batch=batch, seq=seq, lr=lr,
                            log_every=log_every, seed=seed, device=device,
                            ranks=ranks, mesh=mesh)
    from repro_torch.data.synthetic import token_stream

    device = resolve_device(None, device)
    opt_cfg = AdamWConfig(lr=lr)
    params = model.init_params(cfg, seed=seed, device=device, trainable=True)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg, total_steps=steps)
    stream = token_stream(cfg, batch, seq, seed=seed, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={batch} seq={seq}")
    t0 = time.time()
    losses = []
    for i in range(steps):
        params, opt_state, m = step_fn(params, opt_state, next(stream))
        losses.append(float(m["loss"]))
        if i % log_every == 0 or i == steps - 1:
            dt = time.time() - t0
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['gnorm']):.3f} ({dt:.1f}s)")
    return params, losses


def _rank_device(device) -> torch.device:
    """This rank's device (its own card under ``ranks.spawn``), its peak
    memory statistics reset."""
    dev = resolve_device(None, device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    return dev


def _timed_step(step_fn, params, state, batch, mesh, dev):
    """One call of a sharded step: (params, state, metrics, wall seconds
    with the card synchronized before and after, {collective: its
    milliseconds} from ``mesh.time_collectives``: CUDA events on the
    compute stream for a tensor on the card, the host clock for one in
    host memory)."""
    M.reset_comm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with M.bound(mesh), M.time_collectives():
        params, state, metrics = step_fn(params, state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return params, state, metrics, wall, M.collective_ms(by_op=True)


def _peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def train_rank(rank: int, cfg: ModelConfig, steps: int, batch: int, seq: int,
               lr: float, log_every: int, seed: int, shape, device: str):
    """One rank of ``train_loop``'s sharded run: the (data, model) mesh of
    ``shape`` over the group, ``steps`` steps of the sharded step.
    Returns its record: losses and gnorms, each step's wall seconds and
    milliseconds in collectives (``_timed_step``), the peak of allocated
    card memory, and the flash kernels' launches by instance."""
    import torch.distributed as dist
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    dev = _rank_device(device)
    mesh = M._make(shape, ("data", "model"))
    params = shd.init_sharded(cfg, mesh, seed=seed, device=dev)
    opt_state = shd.init_opt_state(cfg, mesh, dev)
    stream = token_stream(cfg, batch, seq, seed=seed, device=dev)
    first = next(stream)
    step_fn, _ = make_jitted_train_step(cfg, AdamWConfig(lr=lr), mesh, first,
                                        total_steps=steps)
    if rank == 0:
        n = sum(p.numel() for p in model.abstract_params(cfg).parameters())
        print(f"model={cfg.name} params={n/1e6:.1f}M batch={batch} "
              f"seq={seq} ranks={mesh.size} mesh={mesh.shape} "
              f"backend={dist.get_backend()}", flush=True)
    ops.reset_launches()
    rec = {"rank": rank, "backend": dist.get_backend(), "card": str(dev),
           "losses": [], "gnorms": [], "step_s": [], "comm_ms": []}
    t0 = time.time()
    b = first
    for i in range(steps):
        params, opt_state, m, wall, comm = _timed_step(
            step_fn, params, opt_state, b, mesh, dev)
        rec["step_s"].append(wall)
        rec["comm_ms"].append(comm)
        rec["losses"].append(float(m["loss"]))
        rec["gnorms"].append(float(m["gnorm"]))
        if rank == 0 and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d} loss={rec['losses'][-1]:.4f} "
                  f"gnorm={rec['gnorms'][-1]:.3f} ({time.time() - t0:.1f}s)",
                  flush=True)
        b = next(stream)
    rec.update(peak_gb=_peak_gb(dev), flash=dict(ops.flash_launches),
               flash_backward=dict(ops.flash_backward_launches),
               tokens=batch * seq)
    return rec


def check_rank(rank: int, cfg: ModelConfig, shape, batch, lr: float,
               seed: int, ref_dir: str, device: str = "cuda"):
    """One rank of a check of the sharded step against the one-rank step
    (``chip_smoke.py`` phase 19): one sharded step on the (data, model)
    mesh of ``shape`` from ``sharding.init_sharded(cfg, mesh, seed)`` on
    the global ``batch``, then each leaf's block against the same block
    of the one-rank result saved whole in ``ref_dir`` (``params.pt``,
    ``m.pt``, ``v.pt``; ``make_train_step`` from ``init_params(cfg,
    seed)``): a weight by the L2 norm of its difference over the L2 norm
    of the reference's update (its distance from the weight before the
    step), a moment by its max |difference| over the reference block's
    max |value|; the weight before the step and zero moments are the
    controls (1 by construction).  Returns the loss and gnorm, the worst
    leaf of each check, the step's wall and collective ms, the flash
    launches by instance and the peak of allocated card memory."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    dev = _rank_device(device)
    mesh = M._make(shape, ("data", "model"))
    params = shd.init_sharded(cfg, mesh, seed=seed, device=dev)
    before = {n: b.detach().to("cpu", copy=True)
              for n, b in shd.blocks(params).items()}
    state = shd.init_opt_state(cfg, mesh, dev)
    step_fn, (p_specs, o_specs, _) = make_jitted_train_step(
        cfg, AdamWConfig(lr=lr), mesh, batch, total_steps=10)
    ops.reset_launches()
    params, state, metrics, wall, comm = _timed_step(
        step_fn, params, state, batch, mesh, dev)
    rec = {"rank": rank, "backend": dist.get_backend(), "card": str(dev),
           "loss": float(metrics["loss"]), "gnorm": float(metrics["gnorm"]),
           "step_ms": 1e3 * wall, "comm_ms": comm,
           "flash": dict(ops.flash_launches),
           "flash_backward": dict(ops.flash_backward_launches),
           "launches": dict(ops.launches)}
    # the whole reference tensors by mmap: a block reads only its pages
    refs = {key: torch.load(os.path.join(ref_dir, f"{key}.pt"), mmap=True,
                            weights_only=True, map_location="cpu")
            for key in ("params", "m", "v")}
    worst = {}
    with M.bound(mesh), torch.no_grad():
        for name, b in shd.blocks(params).items():
            want = M.block(refs["params"][name], p_specs[name]).to(dev)
            move = torch.linalg.vector_norm(
                want.float() - before[name].to(dev).float())
            dev_p = float(torch.linalg.vector_norm(b.float() - want.float())
                          / torch.clamp(move, min=1e-30))
            worst.setdefault("params", []).append((dev_p, name))
            for key in ("m", "v"):
                want = M.block(refs[key][name], o_specs[key][name]).to(dev)
                d = float((state[key][name] - want).abs().max()
                          / torch.clamp(want.abs().max(), min=1e-30))
                worst.setdefault(key, []).append((d, name))
    for key, devs in worst.items():
        devs.sort()
        rec[key] = dict(max=devs[-1][0], leaf=devs[-1][1],
                        median=devs[len(devs) // 2][0], leaves=len(devs))
    rec["peak_gb"] = _peak_gb(dev)
    return rec


def rank_line(rec) -> str:
    """A rank's record in one line: the median over the steps after the
    first (the first builds the groups and warms the allocator)."""
    times = rec["step_s"][1:] or rec["step_s"]
    comm = rec["comm_ms"][1:] or rec["comm_ms"]
    step_ms = 1e3 * statistics.median(times)
    comm_ms = statistics.median(sum(c.values()) for c in comm)
    ops = {op: round(statistics.median(c.get(op, 0.0) for c in comm), 2)
           for op in comm[-1]}
    peak = "n/a" if rec["peak_gb"] is None else f"{rec['peak_gb']:.2f} GB"
    return (f"rank {rec['rank']} ({rec['backend']}, {rec['card']}): step "
            f"{step_ms:.2f} ms, {rec['tokens'] / (step_ms / 1e3):.1f} "
            f"tokens/s, peak {peak}, collectives {comm_ms:.2f} ms a step "
            f"({comm_ms / step_ms:.3f} of it: {ops}), flash forward "
            f"{rec['flash']} backward {rec['flash_backward']}")


def _train_ranks(cfg: ModelConfig, *, steps, batch, seq, lr, log_every, seed,
                 device, ranks, mesh):
    from repro_torch.launch import ranks as R
    shape = tuple(mesh) if mesh is not None else (ranks, 1)
    if math.prod(shape) != ranks:
        raise ValueError(f"mesh {shape} does not hold {ranks} ranks")
    if torch.device(device).type == "cuda":
        import subprocess
        from repro_torch.kernels import build
        resolve_device(None, device)
        # each card's name and power limit, beside the numbers below
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        build.build_all(("ssd_scan", "ssd_backward") if cfg.arch_type == "ssm"
                        else ("flash_attention", "flash_backward"))
    # the ranks' allocators grow their segments rather than cut new ones:
    # the largest leaves' gathers and gradients come and go each layer
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    recs = R.spawn(train_rank, ranks, (cfg, steps, batch, seq, lr, log_every,
                                       seed, shape, device),
                   device=device, deadline_s=600.0 + 300.0 * steps,
                   timeout_s=900.0)
    for rec in recs:
        print(rank_line(rec), flush=True)
    losses = recs[0]["losses"]
    same = all(rec["losses"] == losses for rec in recs)
    print("losses " + " ".join(f"{x:.4f}" for x in losses)
          + f" ({'equal' if same else 'not equal'} on every rank)",
          flush=True)
    if not same or not all(math.isfinite(x) for x in losses):
        raise SystemExit("the ranks' losses differ or are not finite: "
                         + "; ".join(str(rec["losses"]) for rec in recs))
    return recs, losses


def _mesh_arg(text: str):
    return tuple(int(x) for x in text.lower().split("x"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the registry's configuration, not its reduced one")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="(data)x(model) sizes, e.g. 2x2")
    args = ap.parse_args(argv)
    import repro_torch.configs as configs
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, device=args.device, ranks=args.ranks,
               mesh=args.mesh)


if __name__ == "__main__":
    main()
