"""Serving: batched one-token decode (serve_step), its sharded form over a
mesh of ranks, and a tiny greedy loop.

Counterpart of ``repro.launch.serve``.  ``make_serve_step`` is the eager
step on one card.  ``make_jitted_serve_step`` returns JAX's (step,
(p_specs, c_specs)): the weights placed on "model" alone
(``param_pspecs(..., fsdp=False)``: 2-D-sharded weights would be
gathered for every token), the decode cache by ``cache_pspecs`` (S on
"model", B on the data axes, the SSM and LRU states' feature dim on
"model"), the token rows on the data axes where the batch divides them.
The compute is the port's: tensor-parallel decode over "model"
(``models.tp``) on each rank's blocks, with no weight gathered inside a
step.  Under a split of the rows MoE's scatter route slots its tokens in
global order (``moe.rows_split``).

Run as a script (or ``launch.cli serve --ranks``), it serves a model on
ranks started by ``launch.ranks.spawn`` (NCCL with a card a rank): a
lockstep greedy loop through the sharded step, the prompt stepped in as
``greedy_generate`` does, each rank printing ms a token (CUDA events, the
median after warm-up), tokens/s, the card's peak memory and the
collectives' ms and bytes a step; with ``--check`` the one-card eager
step runs first from the same weights, and each rank's logits, fed the
same tokens, are held against it.

    python3 -m repro_torch.launch.serve --ranks 4 --mesh 1x4 --arch qwen3-32b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --ranks 4 --mesh 2x2 --reduced --batch 4 --max-len 64
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import P
from repro_torch.models import blocks, layers, model, moe, tp
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import refuse_encoder_decoder


def make_serve_step(cfg: ModelConfig, mode: str = "decode"):
    """serve_step(params, cache, token, pos) -> (next_token (B,) int32,
    logits (B, V), cache); the cache is updated in place."""
    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, cache, token, pos, cfg,
                                          mode=mode)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return serve_step


# where each cache leaf of a layer holds the dim the decode splits on
# "model": S of the KV cache and its scales, the conv's channels, the
# SSM state's heads, the LRU state's width
_NATIVE = {"k": 1, "v": 1, "k_scale": 1, "v_scale": 1, "conv": -1, "ssm": 1,
           "h": -1}


def _layer_specs(c_specs, i: int, cfg: ModelConfig) -> Dict[str, P]:
    """Layer i's cache specs (``model.layer_cache`` over the specs: a
    stacked leaf's L entry dropped)."""
    if "layers" in c_specs:
        return {n: P(*s[1:]) for n, s in c_specs["layers"].items()}
    pat, n_rep, _ = model.hybrid_layout(cfg)
    if i < n_rep * len(pat):
        return {n: P(*s[1:])
                for n, s in c_specs["pattern_layers"][i % len(pat)].items()}
    return dict(c_specs["tail_layers"][i - n_rep * len(pat)])


def _leaf_layout(name: str, spec: P, mesh, native: int, rows_split: bool):
    """(the native dim on "model", the rows to narrow to this rank's) for a
    layer's cache leaf under ``spec``; a leaf split on a dim the decode
    does not read raises."""
    dp = shd._data_entry(mesh)
    native %= len(spec)
    split = rows_on = False
    for d, ax in enumerate(spec):
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if math.prod(mesh.shape[a] for a in names) == 1:
            continue
        if d == 0 and ax == dp:
            rows_on = True
        elif d == native and ax == "model":
            split = True
        else:
            raise NotImplementedError(
                f"cache leaf {name}: spec {spec} splits dim {d}, which the "
                "tensor-parallel decode does not read split")
    return split, rows_split and not rows_on


def token_spec(mesh, batch: int) -> P:
    """JAX's ``tok_spec``: the token rows on the data axes where their
    product divides ``batch``, else replicated."""
    groups = math.prod(mesh.shape[a] for a in M.data_axes(mesh))
    return P(shd._data_entry(mesh)) if batch % groups == 0 else P()


def make_jitted_serve_step(cfg: ModelConfig, mesh, batch: int, max_len: int,
                           mode: str = "decode"):
    """The step over ``mesh`` (module docstring), and JAX's specs: returns
    (step, (p_specs, c_specs)).

    ``step(params, cache, token, pos)`` is called on every rank: ``params``
    a model sharded with ``fsdp=False`` (``sharding.init_sharded`` /
    ``shard_params``; at a mesh of one rank also a whole model),
    ``cache`` the rank's blocks of ``model.init_cache(cfg, batch,
    max_len, mode)`` under ``c_specs`` (``sharding.init_cache_blocks``, or
    ``sharding.shard_cache`` of a whole one), ``token`` the (batch,) ids or
    this rank's rows of them, ``pos`` a scalar or (batch,) positions.  It
    updates the cache's blocks in place and returns (next_token (rows,)
    int32, logits (rows, V), cache) for this rank's rows (all ``batch``
    where the data axes do not split them), whole on every rank of its
    data group, as JAX's out_shardings replicate them over "model".  Its
    first call on a model gathers the small leaves (``serve_leaves``)."""
    p_specs = shd.param_pspecs(model.abstract_params(cfg), mesh, fsdp=False)
    c_specs = shd.cache_pspecs(shd.abstract_cache(cfg, batch, max_len, mode),
                               cfg, mesh)
    dp = M.data_axes(mesh)
    groups = math.prod(mesh.shape[a] for a in dp)
    tok_spec = token_spec(mesh, batch)
    rows_split = groups > 1 and batch % groups == 0
    rows = batch // groups if rows_split else batch
    window = model._decoder_window(cfg, "long" if mode == "long"
                                   else "decode")
    kinds = blocks.block_kinds(cfg)
    layout = [{name: _leaf_layout(name, spec, mesh, _NATIVE[name],
                                  rows_split)
               for name, spec in _layer_specs(c_specs, i, cfg).items()}
              for i in range(cfg.num_layers)]
    cross = None
    if cfg.is_encoder_decoder:
        # k and v share their shape, so their spec: F on "model" or not
        cross, narrow = _leaf_layout("cross_kv/k", P(*c_specs["cross_kv"][
            "k"][1:]), mesh, 1, rows_split)
        if narrow:
            raise NotImplementedError("cross_kv not split on the batch's "
                                      "rows where the rows are")

    def mine(a, device):
        a = torch.as_tensor(a, device=device)
        if a.ndim and rows_split and a.shape[0] == batch:
            return M.block(a, tok_spec)
        return a

    def step(params, cache, token, pos):
        with M.bound(mesh), torch.no_grad():
            leaves, _ = serve_leaves(params, mesh, p_specs)
            dev = leaves.embed.block.device
            token, pos = mine(token, dev).long(), mine(pos, dev)
            first = M.axis_index(dp) * rows if rows_split else 0
            split = (moe.rows_split(
                lambda t: M.collective("psum", t, dp),
                lambda t: M.collective("all_gather", t, dp),
                M.axis_index(dp)) if rows_split
                else contextlib.nullcontext())
            with split:
                x = tp.embed(leaves, token, pos, cfg)
                for i, kind in enumerate(kinds):
                    views = model.layer_cache(cache, i, cfg)
                    ours = {n: v.narrow(0, first, rows)
                            if layout[i][n][1] else v
                            for n, v in views.items()}
                    where = {n: s for n, (s, _) in layout[i].items()}
                    kv = None
                    if cross is not None:
                        kv = {n: t[i] for n, t in cache["cross_kv"].items()}
                        where["cross"] = cross
                    x, _ = tp.block_decode(leaves.layers[i], x, ours, pos,
                                           cfg, kind, where, window=window,
                                           cross_kv=kv)
                    for n, v in views.items():
                        # a leaf whose batch stays whole while the rows
                        # split: every rank of the data axes gets the rows
                        # the others wrote
                        if layout[i][n][1]:
                            v.copy_(M.collective("all_gather", ours[n], dp))
            x = layers.apply_norm(x, leaves.final_norm, cfg.norm)
            logits = tp.head(leaves, x, cfg)[:, 0]
            next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return step, (p_specs, c_specs)


def serve_leaves(params: model.LM, mesh, p_specs=None):
    """(``tp.prepare``'s leaves of ``params``, the bytes of the small
    leaves it all-gathered), made on the first call for ``mesh`` and kept
    on the model.  ``params`` is sharded under ``p_specs`` (the serve
    step's ``fsdp=False`` specs), or whole on a mesh of one rank."""
    kept = params.__dict__.get("_serve_leaves")
    if kept is not None and kept[0] == mesh:
        return kept[1]
    if p_specs is None:
        p_specs = shd.param_pspecs(model.abstract_params(params.cfg), mesh,
                                   fsdp=False)
    specs = getattr(params, "specs", None)
    if specs is None and mesh.size > 1:
        raise ValueError("the sharded serve step takes a sharded model "
                         "(sharding.init_sharded / shard_params, "
                         "fsdp=False)")
    if specs is not None and specs != p_specs:
        raise ValueError("the model's blocks are not under the serve "
                         "step's specs (param_pspecs(..., fsdp=False))")
    made = tp.prepare(shd.blocks(params), p_specs, mesh)
    params.__dict__["_serve_leaves"] = (mesh, made)
    return made


def greedy_generate(cfg: ModelConfig, params: model.LM, prompt,
                    max_new: int = 32) -> torch.Tensor:
    """Greedy generation that prefills by stepping the prompt.  prompt:
    (B, S0) token ids; returns (B, S0 + max_new) int32 on the params'
    device.  An encoder-decoder config raises NotImplementedError, as in
    ``ServeEngine``."""
    refuse_encoder_decoder(cfg, "greedy_generate")
    prompt = torch.as_tensor(prompt, device=params.device,
                             dtype=torch.int32)
    B, S0 = prompt.shape
    cache = model.init_cache(cfg, B, S0 + max_new, device=params.device)
    step = make_serve_step(cfg)
    tok = prompt[:, 0]
    out = [tok]
    for t in range(S0 + max_new - 1):
        nxt, _, cache = step(params, cache, tok, t)
        tok = prompt[:, t + 1] if t + 1 < S0 else nxt
        out.append(tok)
    return torch.stack(out, dim=1)


# --------------------------------------------------------------------------
# Serving on ranks
# --------------------------------------------------------------------------


def prompt_tokens(cfg: ModelConfig, batch: int, length: int,
                  seed: int) -> np.ndarray:
    """The (batch, length) prompt of a run, from ``seed``."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int64)


def reference_run(cfg: ModelConfig, batch: int, prompt_len: int,
                  steps: int, seed: int, out_path: str, device="cuda"):
    """The one-rank run a sharded run is held against: ``init_params(cfg,
    seed)``, a cache of ``steps`` + 1 positions, ``steps`` eager steps of
    ``make_serve_step`` from the prompt (stepped in, then greedy).  Saves
    {"tokens" (batch, steps + 1): the tokens fed, then the last
    prediction; "next" (batch, steps): each step's prediction; "logits"
    (steps, batch, V)} at ``out_path``; returns the median ms a step after
    two and the peak of allocated card memory.  Frees the card."""
    from repro_torch.core.admm import resolve_device
    device = resolve_device(None, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = model.init_params(cfg, seed=seed, device=device)
    cache = model.init_cache(cfg, batch, steps + 1, device=device)
    step = make_serve_step(cfg)
    prompt = torch.as_tensor(prompt_tokens(cfg, batch, prompt_len, seed),
                             device=device)
    tok, fed, nexts, logits, times = prompt[:, 0], [], [], [], []
    for t in range(steps):
        t0 = time.perf_counter()
        nxt, lg, cache = step(params, cache, tok, t)
        logits.append(lg.cpu())
        times.append(time.perf_counter() - t0)
        fed.append(tok.cpu())
        nexts.append(nxt.cpu())
        tok = prompt[:, t + 1] if t + 1 < prompt_len else nxt.long()
    fed.append(tok.cpu())
    torch.save({"tokens": torch.stack(fed, 1), "next": torch.stack(nexts, 1),
                "logits": torch.stack(logits)}, out_path)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    del params, cache
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(ms=1e3 * statistics.median(times[2:] or times),
                peak_bytes=peak)


def _timed(step, params, cache, token, pos, mesh, dev):
    """One step: (next_token, logits, cache, ms by CUDA events (the host
    clock on the CPU), collective ms by op, collective bytes by op)."""
    M.reset_comm()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    with M.bound(mesh), M.time_collectives():
        nxt, logits, cache = step(params, cache, token, pos)
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = 1e3 * (time.perf_counter() - t0)
    return (nxt, logits, cache, ms, M.collective_ms(by_op=True),
            dict(M.comm_bytes))


def serve_rank(rank: int, cfg: ModelConfig, shape, batch: int,
               prompt_len: int, max_new: int, max_len: int, seed: int,
               device: str, ref_path: Optional[str] = None,
               teacher: bool = True, profile: int = 0):
    """One rank of a sharded serving run on the (data, model) mesh of
    ``shape``: ``init_sharded(cfg, mesh, seed, fsdp=False)``, the cache's
    blocks at ``max_len``, the lockstep greedy loop (the prompt stepped
    in, then ``max_new`` - 1 more steps).  With ``ref_path``
    (``reference_run``'s file of the same prompt and seed) each step's
    logits are held against the reference's (max |dev| over the steps,
    and the control: the reference one position earlier) and its
    predictions against the reference's; ``teacher`` feeds the
    reference's tokens, else the rank's own.  The last ``profile`` steps
    run under ``torch.profiler`` (their times kept apart): the device
    time of their kernels, NCCL's apart, and the launches a step.
    Returns the rank's record:
    ms, collective ms and bytes a step, the small leaves' gathered bytes,
    the ``Gather`` forwards during the steps, the peak of allocated card
    memory, the kernel launches (decode runs none), its rows'
    predictions."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.train import _rank_device
    dev = _rank_device(device)
    mesh = M._make(shape, ("data", "model"))
    params = shd.init_sharded(cfg, mesh, seed=seed, device=dev, fsdp=False,
                              trainable=False)
    cache = shd.init_cache_blocks(cfg, mesh, batch, max_len, device=dev)
    step, _ = make_jitted_serve_step(cfg, mesh, batch, max_len)
    _, leaf_bytes = serve_leaves(params, mesh)
    spec = token_spec(mesh, batch)
    ref = None
    if ref_path is not None:
        ref = torch.load(ref_path, mmap=True, weights_only=True,
                         map_location="cpu")
    with M.bound(mesh):
        prompt = M.block(torch.as_tensor(prompt_tokens(
            cfg, batch, prompt_len, seed), device=dev), spec)
        if ref is not None:
            fed = M.block(ref["tokens"], spec).to(dev)
            want_next = M.block(ref["next"], spec)
    n_steps = prompt_len + max_new - 1
    rec = {"rank": rank, "backend": dist.get_backend(), "card": str(dev),
           "ms": [], "comm_ms": [], "comm_bytes": [], "next": [],
           "leaf_bytes": leaf_bytes, "dev": [], "control": []}
    shd.reset_gathers()
    ops.reset_launches()
    tok = prompt[:, 0]
    prof = None
    for t in range(n_steps):
        if t == n_steps - profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            rec["profiled_ms"] = []
        nxt, logits, cache, ms, comm, nbytes = _timed(
            step, params, cache, tok, t, mesh, dev)
        rec["profiled_ms" if prof else "ms"].append(ms)
        if not prof:
            rec["comm_ms"].append(comm)
            rec["comm_bytes"].append(nbytes)
        rec["next"].append(nxt.cpu())
        if ref is not None:
            got = logits.float().cpu()
            with M.bound(mesh):
                rec["dev"].append(float((got - M.block(
                    ref["logits"][t], spec).float()).abs().max()))
                if t:
                    rec["control"].append(float((got - M.block(
                        ref["logits"][t - 1], spec).float()).abs().max()))
        if ref is not None and teacher:
            tok = fed[:, t + 1]
        else:
            tok = prompt[:, t + 1] if t + 1 < prompt_len else nxt.long()
    if prof is not None:
        prof.__exit__(None, None, None)
        rec["profile"] = _device_split(prof, profile)
    rec.update(gather_forwards=shd.gathers["forward"],
               launches={k: v for k, v in ops.launches.items() if v},
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
               batch=batch, steps=n_steps, dtype=cfg.param_dtype,
               teacher=teacher and ref is not None)
    rec["next"] = torch.stack(rec["next"], 1)
    if ref is not None:
        rec["next_equal"] = bool(torch.equal(rec["next"].long(),
                                             want_next.long()))
    return rec


def _device_split(prof, steps: int) -> dict:
    """A profiled window's kernels a step: device ms of the compute
    kernels and of NCCL's (which wait on the other ranks inside), and
    the launches."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == cuda]
    nccl = sum(us for name, us in kernels if "nccl" in name.lower())
    return dict(compute_ms=(sum(us for _, us in kernels) - nccl)
                / 1e3 / steps, nccl_ms=nccl / 1e3 / steps,
                launches=len(kernels) / steps)


def serve_rank_runs(rank: int, runs):
    """``serve_rank`` for each of ``runs`` (its keyword arguments) on this
    rank, in turn: the records."""
    return [serve_rank(rank, **run) for run in runs]


# steps left out of a run's medians: the first builds the groups and
# gathers the small leaves, the second warms the allocator
WARMUP = 2


def summary(rec) -> dict:
    """A rank's record reduced: medians over the steps after WARMUP."""
    w = WARMUP
    ms = statistics.median(rec["ms"][w:] or rec["ms"])
    comm = rec["comm_ms"][w:] or rec["comm_ms"]
    nbytes = rec["comm_bytes"][w:] or rec["comm_bytes"]
    out = dict(ms=ms, tokens_per_s=rec["batch"] / (ms / 1e3),
               comm_ms=statistics.median(sum(c.values()) for c in comm),
               comm_bytes=statistics.median(sum(b.values()) for b in nbytes),
               comm_bytes_by_op={op: statistics.median(b.get(op, 0)
                                                       for b in nbytes)
                                 for op in nbytes[-1]},
               peak_gb=rec["peak_gb"], leaf_bytes=rec["leaf_bytes"],
               gather_forwards=rec["gather_forwards"])
    if rec["dev"]:
        out.update(dev=max(rec["dev"]), control=min(rec["control"]),
                   next_equal=rec["next_equal"])
    if "profile" in rec:
        out.update(profile=rec["profile"],
                   profiled_ms=statistics.median(rec["profiled_ms"]))
    return out


def rank_line(rec) -> str:
    """A rank's record in one line (``summary``)."""
    s = summary(rec)
    peak = "n/a" if s["peak_gb"] is None else f"{s['peak_gb']:.2f} GB"
    line = (f"rank {rec['rank']} ({rec['backend']}, {rec['card']}, "
            f"{rec['dtype']}): {s['ms']:.2f} ms a token (median of steps "
            f"{WARMUP}-{len(rec['ms']) - 1}), {s['tokens_per_s']:.1f} "
            f"tokens/s, peak {peak}, collectives {s['comm_ms']:.2f} ms and "
            f"{s['comm_bytes'] / 1e6:.4f} MB a step (bytes by op "
            f"{s['comm_bytes_by_op']}), small leaves gathered once "
            f"{s['leaf_bytes'] / 1e6:.4f} MB, Gather forwards "
            f"{s['gather_forwards']}")
    if "profile" in s:
        p = s["profile"]
        line += (f"; profiled, the last {len(rec['profiled_ms'])} steps: "
                 f"{s['profiled_ms']:.2f} ms a step, kernels "
                 f"{p['compute_ms']:.2f} ms of device time and NCCL's "
                 f"{p['nccl_ms']:.2f} ms, {p['launches']:.0f} launches a "
                 "step")
    if "dev" in s:
        fed = "its tokens" if rec["teacher"] else "own tokens"
        line += (f"; logits against one card ({fed}): max|dev| "
                 f"{s['dev']:.4e}, control "
                 f"(one position earlier) {s['control']:.4e}, predictions "
                 f"{'equal' if s['next_equal'] else 'differ'}")
    return line


def serve_ranks(cfg: ModelConfig, *, ranks: int, mesh, batch: int,
                prompt_len: int, max_new: int, max_len: int, seed: int = 0,
                device="cuda", check: bool = False, ref_dir: str = "build",
                profile: int = 0, tol: Optional[float] = None):
    """Sharded serving on ``ranks`` processes (``launch.ranks.spawn``), on
    the (data, model) mesh ``mesh`` ((1, ranks) if None), or on each of a
    list of meshes in turn; with ``check`` the one-card reference first
    (``reference_run``, saved under ``ref_dir`` and removed after);
    ``profile``: the last steps profiled (``serve_rank``); with ``tol``
    a rank whose logits are farther than ``tol`` from the reference's, or
    whose control is not, fails the call (``SystemExit``).
    Prints each card's name and power limit, then a line a rank a mesh;
    returns the records by mesh."""
    from repro_torch.launch import ranks as R
    shapes = ([(1, ranks)] if mesh is None else
              [tuple(mesh)] if isinstance(mesh[0], int)
              else [tuple(m) for m in mesh])
    for shape in shapes:
        if math.prod(shape) != ranks:
            raise ValueError(f"mesh {shape} does not hold {ranks} ranks")
    if torch.device(device).type == "cuda":
        import subprocess
        from repro_torch.core.admm import resolve_device
        resolve_device(None, device)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    n = sum(p.numel() for p in model.abstract_params(cfg).parameters())
    print(f"model={cfg.name} params={n / 1e9:.3f}B ({cfg.param_dtype}) "
          f"layers={cfg.num_layers} batch={batch} prompt={prompt_len} "
          f"new={max_new} max_len={max_len} ranks={ranks} meshes={shapes}",
          flush=True)
    ref_path = None
    if check:
        os.makedirs(ref_dir, exist_ok=True)
        ref_path = os.path.join(ref_dir, f"serve_reference_{cfg.name}.pt")
        t0 = time.perf_counter()
        one = reference_run(cfg, batch, prompt_len, prompt_len + max_new - 1,
                            seed, ref_path, device)
        peak = ("n/a" if one["peak_bytes"] is None
                else f"{one['peak_bytes'] / 1e9:.2f} GB")
        print(f"one card (eager make_serve_step): {one['ms']:.2f} ms a "
              f"token, peak {peak}, {time.perf_counter() - t0:.1f} s with "
              "the weights' draw", flush=True)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    out = {}
    try:
        for shape in shapes:
            t0 = time.perf_counter()
            out[shape] = R.spawn(serve_rank, ranks, (
                cfg, shape, batch, prompt_len, max_new, max_len, seed,
                device, ref_path, True, profile), device=device,
                deadline_s=1800.0,
                timeout_s=900.0)
            print(f"mesh {shape}: {time.perf_counter() - t0:.1f} s with the "
                  "ranks' start and the weights' draw", flush=True)
            for rec in out[shape]:
                print(rank_line(rec), flush=True)
    finally:
        if ref_path is not None and os.path.exists(ref_path):
            os.remove(ref_path)
    if check and tol is not None:
        worst = max(max(r["dev"]) for recs in out.values() for r in recs)
        control = min(min(r["control"]) for recs in out.values()
                      for r in recs)
        print(f"logits against one card: max|dev| {worst:.4e} (limit "
              f"{tol:g}), control {control:.4e}", flush=True)
        if not worst <= tol < control:
            raise SystemExit(f"logits max|dev| {worst:.4e} or control "
                             f"{control:.4e} against the limit {tol:g}")
    return out


def mesh_arg(text: str):
    """"1x4" -> (1, 4); "1x4,2x2" -> [(1, 4), (2, 2)]."""
    shapes = [tuple(int(x) for x in part.lower().split("x"))
              for part in text.split(",")]
    return shapes[0] if len(shapes) == 1 else shapes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mesh", type=mesh_arg, default=None,
                    help="(data)x(model) sizes, e.g. 1x4 (the default), or "
                         "several: 1x4,2x2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", dest="prompt_len", type=int, default=64)
    ap.add_argument("--max-new", dest="max_new", type=int, default=64)
    ap.add_argument("--max-len", dest="max_len", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="hold the logits against the one-card eager step")
    ap.add_argument("--profile", type=int, default=0,
                    help="profile the last N steps (kept out of the median)")
    ap.add_argument("--tol", type=float, default=None,
                    help="with --check: the limit of the logits' max|dev|")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import repro_torch.configs as configs
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    serve_ranks(cfg, ranks=args.ranks, mesh=args.mesh, batch=args.batch,
                prompt_len=args.prompt_len, max_new=args.max_new,
                max_len=args.max_len, seed=args.seed, device=args.device,
                check=args.check, profile=args.profile, tol=args.tol)


if __name__ == "__main__":
    main()
