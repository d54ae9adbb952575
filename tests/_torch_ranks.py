"""Rank workers of ``tests/test_torch_ranks.py``: every case of that module
on one rank of a gloo group on the CPU (``repro_torch.launch.ranks.
spawn``), and on rank 0 the same calls at one rank.  Imports nothing of
JAX: the inputs are drawn here with numpy from their seeds (the port's
``simulate`` and ``graph`` give JAX's bits), and JAX's rho comes in as
an argument."""
import numpy as np
import torch

from repro_torch import core
from repro_torch.core import decentral as dec
from repro_torch.core import graph
from repro_torch.launch import mesh

# the JAX tests' sizes (tests/test_distributed.py, tests/test_chunked.py)
SIM = core.SimConfig(p=30, s=5, m=8, n=50)
HANDOFF = core.SimConfig(p=20, s=4, m=4, n=60)
ON = dict(device="cpu")


def _labels(X, rng):
    b = np.zeros(X.shape[2], np.float32)
    b[:2] = 1.0
    return np.sign(X @ b + 0.1 * rng.normal(size=X.shape[:2])).astype(
        np.float32)


def _chunk_problem(seed, m, n, p):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, n, p)).astype(np.float32)
    return X, _labels(X, rng)


def inputs():
    """Every case's numpy inputs, from their seeds."""
    X, y, _ = core.generate(SIM, seed=2)
    Xh, yh, _ = core.generate(HANDOFF, seed=1)
    Xc, yc = _chunk_problem(0, 16, 10, 6)
    Xu, yu = _chunk_problem(3, 13, 10, 6)
    Xb, yb = _chunk_problem(5, 16, 12, 6)
    return dict(
        X=X, y=y, W=graph.erdos_renyi(8, 0.5, seed=3), Wr=graph.ring(8),
        lams=core.tuning.lambda_grid(X, y, num=4).astype(np.float32),
        w=np.random.default_rng(1).uniform(0.1, 1.0, 31).astype(np.float32),
        w2=np.random.default_rng(0).uniform(0.2, 1.0, 31).astype(np.float32),
        Xh=Xh, yh=yh, Wh=graph.erdos_renyi(4, 0.8, seed=0),
        lams_h=np.geomspace(0.3, 0.02, 8).astype(np.float32),
        Xc=Xc, yc=yc, Wc=graph.erdos_renyi(16, 0.4, seed=1),
        lams_c=np.geomspace(0.5, 0.05, 4).astype(np.float32),
        Xu=Xu, yu=yu, Wu=graph.ring(13),
        Xb=Xb, yb=yb, Wb=graph.ring(16),
        grads=np.random.default_rng(7).normal(size=(8, 3, 2)).astype(
            np.float32),
        Wmix=np.random.default_rng(8).uniform(size=(8, 8)).astype(
            np.float32))


def _cfg(**kw):
    return core.ADMMConfig(**kw)


def _fits(d, rho, k):
    """The gather and ring fits (with and without lam_weights) and
    sharded paths on the ("node",) mesh of ``k`` ranks."""
    node, out = mesh.make_node_mesh(k), {}
    cfg = _cfg(lam=0.05, max_iter=80)
    for sched, W in (("gather", d["W"]), ("ring", d["Wr"])):
        for tag, w in (("", None), (" lamw", d["w"])):
            out[f"fit {sched}{tag}"] = dec.decsvm_fit_sharded(
                d["X"], d["y"], W, cfg, mesh=node, schedule=sched,
                lam_weights=w, rho=rho["X"], **ON)
        out[f"path_sharded {sched}"] = dec.decsvm_path_sharded(
            d["X"], d["y"], W, d["lams"], _cfg(lam=0.0, max_iter=80),
            mesh=node, schedule=sched, rho=rho["X"], **ON)
    with mesh.bound(node):
        spec = mesh.P("node")
        local = dec.consensus_mix(
            mesh.block(torch.as_tensor(d["grads"]), spec),
            mesh.block(torch.as_tensor(d["Wmix"]), spec))
        out["consensus"] = mesh.assemble(local, spec)
    return out


def _mesh_paths(d, rho, k):
    """The (node, lam) path on the mesh ``_choose_mesh_shape`` picks for
    ``k`` ranks: batched BIC, warm, CV, lam_weights; and the mesh route of
    ``select_lambda_path`` and the sharded LLA fit on the group's own
    meshes."""
    node_lam = mesh.make_node_lam_mesh(*dec._choose_mesh_shape(8, 4, k))
    args = (d["X"], d["y"], d["W"], d["lams"], _cfg(lam=0.0, max_iter=80))
    kw = dict(mesh=node_lam, rho=rho["X"], **ON)
    # the routes through tuning and the LLA fit take the group's meshes
    # by default; their one-rank reference is the dense route
    route = dict(engine="dense") if k == 1 else dict(engine="mesh")
    lla = dict(engine="dense") if k == 1 else dict(engine="sharded")
    return {
        "tuning": core.tuning.select_lambda_path(
            *args[:3], args[4], lams=d["lams"], mode="batched",
            rho=rho["X"], **route, **ON)[3]._asdict(),
        "lla": core.penalties.decsvm_fit_lla(
            *args[:3], _cfg(lam=0.05, max_iter=80), penalty="scad",
            lams=d["lams"], path_mode="batched", rho=rho["X"], **lla, **ON),
        "mesh bic": dec.decsvm_path_mesh(*args, **kw)._asdict(),
        "mesh warm": dec.decsvm_path_mesh(*args, mode="warm", tol=1e-4,
                                          **kw)._asdict(),
        "mesh cv": dec.decsvm_path_mesh(*args, criterion="cv", cv_folds=3,
                                        cv_rho=rho["X cv"], **kw)._asdict(),
        "mesh lamw": dec.decsvm_path_mesh(*args, lam_weights=d["w2"],
                                          **kw)._asdict()}


def _handoff(d, rho, k):
    """The warm path on ``k`` lam shards, with and without the hand-off."""
    hmesh = mesh.make_node_lam_mesh(1, k)
    return {f"handoff {on}": dec.decsvm_path_mesh(
        d["Xh"], d["yh"], d["Wh"], d["lams_h"], _cfg(lam=0.05, max_iter=800),
        mesh=hmesh, mode="warm", tol=1e-5, handoff=on, rho=rho["Xh"],
        **ON)._asdict() for on in (True, False)}


def _chunked(d, rho, k):
    """The chunked fit (three backends, and ``tol=``), the chunked path,
    and m = 13 with its raw padded state, on ``k`` node chunks."""
    chunk, out = mesh.make_node_chunk_mesh(k), {}
    for backend in ("jnp", "pallas", "megakernel"):
        out[f"chunked {backend}"] = dec.decsvm_fit_chunked(
            d["Xc"], d["yc"], d["Wc"],
            _cfg(lam=0.1, max_iter=40, backend=backend), mesh=chunk,
            rho=rho["Xc"], **ON)
    ccfg = _cfg(lam=0.1, max_iter=200)
    out["chunked tol"] = dec.decsvm_fit_chunked(
        d["Xc"], d["yc"], d["Wc"], ccfg, mesh=chunk, tol=1e-6,
        rho=rho["Xc"], **ON)
    out["chunked path"] = dec.decsvm_path_chunked(
        d["Xc"], d["yc"], d["Wc"], d["lams_c"], ccfg, mesh=chunk,
        rho=rho["Xc"], **ON)
    ucfg = _cfg(lam=0.1, max_iter=40)
    top = graph.BlockTopology.from_dense(d["Wu"])
    out["uneven"] = dec.decsvm_fit_chunked(d["Xu"], d["yu"], top, ucfg,
                                           mesh=chunk, rho=rho["Xu"], **ON)
    X, y = torch.as_tensor(d["Xu"]), torch.as_tensor(d["yu"])
    ops, offsets, m_pad = dec._chunk_prep(X, y, top, ucfg, chunk,
                                          torch.as_tensor(rho["Xu"]))
    fitted = dec.build_chunked_admm(m_pad, X.shape[2], ucfg, chunk, offsets)
    out["uneven raw"], _ = fitted(
        ops["X"], ops["y"], ops["W_diag"], ops["W_off"], ops["deg"],
        ops["rho"], torch.ones(X.shape[2]), ops["nmask"])
    return out


def _block_meshes(d, rho, k):
    """The (node, lam) path under the gather and the block schedules,
    BIC and CV, on the mesh ``_choose_mesh_shape`` picks for ``k``."""
    shape, bcfg, out = dec._choose_mesh_shape(16, 4, k), _cfg(
        lam=0.1, max_iter=40), {}
    for sched, mk in (("gather", mesh.make_node_lam_mesh),
                      ("block", mesh.make_chunk_lam_mesh)):
        for crit in ("bic", "cv"):
            out[f"block_mesh {sched} {crit}"] = dec.decsvm_path_mesh(
                d["Xb"], d["yb"], d["Wb"], d["lams_c"], bcfg,
                mesh=mk(*shape), schedule=sched, criterion=crit,
                cv_folds=3, rho=rho["Xb"], cv_rho=rho["Xb cv"],
                **ON)._asdict()
    return out


GROUPS = (_fits, _mesh_paths, _handoff, _chunked, _block_meshes)
# the hand-off's reference is JAX's dense warm path (the one-rank engine
# makes another traversal), so it has no one-rank run
ONE_RANK = (_fits, _mesh_paths, _chunked, _block_meshes)


def work(rank, rho, one_rank: bool):
    """``spawn``'s ``fn``: every case across the group's ranks, then, with
    ``one_rank``, this rank's share of the same calls at one rank (group i
    of ``ONE_RANK`` on rank i mod the group's size).  ``rho`` holds JAX's
    step sizes."""
    d, k = inputs(), mesh.device_count()
    got, one = {}, {}
    for g in GROUPS:
        got.update(g(d, rho, k))
    for i, g in enumerate(ONE_RANK):
        if one_rank and i % k == rank:
            one.update(g(d, rho, 1))
    return dict(ranks=got, one=one, world=k)


def fail(rank):
    """``spawn``'s ``fn`` for the failure check: rank 1 raises while the
    others wait for it in a collective."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 raises on purpose")
    dist.barrier()


def abort(rank):
    """``spawn``'s ``fn`` for the signal check: rank 1 dies by SIGABRT, as
    a C++ abort kills it, while the others wait for it in a collective."""
    import os
    import torch.distributed as dist
    if rank == 1:
        os.abort()
    dist.barrier()


def hang(rank):
    """``spawn``'s ``fn`` for the deadline check: the rank never returns."""
    import time
    time.sleep(3600)


def fit_on_card(rank, X, y, W, max_iter):
    """``spawn``'s ``fn`` on the card: the sharded gather fit under
    ``megakernel`` on the ("node",) mesh of the group, with its
    ``csvm_block_update`` launches by instance and the group's backend."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    ops.reset_launches()
    cfg = core.ADMMConfig(lam=0.05, max_iter=max_iter, backend="megakernel")
    B = dec.decsvm_fit_sharded(X, y, W, cfg, device="cuda")
    return dict(B=B.cpu(), launches=ops.launches["csvm_block_update"],
                instances=dict(ops.two_pass_launches),
                backend=dist.get_backend())


def sharded_train(rank, cases):
    """``spawn``'s ``fn`` of ``tests/test_torch_sharded_train.py``: each
    case's one step of ``launch.train.make_jitted_train_step`` on its
    (data, model) mesh of the group, from the JAX parameter tree it
    carries (numpy) and its global batch.  Returns, by case, the metrics,
    every whole weight after the step (``gather_params``), this rank's
    moment blocks, the step's specs and its collective bytes
    (``mesh.comm_bytes``); a case that raises returns its error's type
    and message instead."""
    import dataclasses

    import repro_torch.configs as tconfigs
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.optim import AdamWConfig
    out = {}
    for key, c in cases.items():
        cfg = dataclasses.replace(tconfigs.get_reduced(c["arch"]),
                                  param_dtype="float32", **c.get("cfg", {}))
        m = mesh._make(c["shape"], ("data", "model"))
        lm = shd.shard_params(convert.params_from_jax(c["tree"], cfg, "cpu"),
                              m, fsdp=c["fsdp"])
        for p in lm.parameters():
            p.requires_grad_(True)
        state = shd.init_opt_state(cfg, m, "cpu")
        step, specs = train.make_jitted_train_step(
            cfg, AdamWConfig(lr=c["lr"]), m, c["batch"], total_steps=10,
            fsdp=c["fsdp"])
        mesh.reset_comm()
        try:
            with mesh.bound(m):
                _, state, metrics = step(lm, state, c["batch"])
        except NotImplementedError as err:
            out[key] = dict(error=f"{type(err).__name__}: {err}")
            continue
        comm_bytes = dict(mesh.comm_bytes)
        out[key] = dict(metrics={k: float(v) for k, v in metrics.items()},
                        params=shd.gather_params(lm),
                        m=state["m"], v=state["v"], step=int(state["step"]),
                        specs=specs, comm_bytes=comm_bytes)
    return out


def init_blocks(rank, arch, shape, seed, over):
    """``spawn``'s ``fn``: ``sharding.init_sharded``'s whole weights
    (``gather_params``) and this rank's blocks, bf16 as configured (with
    the config overrides ``over``)."""
    import repro_torch.configs as tconfigs
    from repro_torch.launch import sharding as shd
    cfg = tconfigs.get_reduced(arch, **over)
    m = mesh._make(shape, ("data", "model"))
    lm = shd.init_sharded(cfg, m, seed=seed, device="cpu")
    return dict(whole=shd.gather_params(lm),
                blocks={k: v.detach().clone()
                        for k, v in shd.blocks(lm).items()},
                specs=dict(lm.specs))


def sharded_serve(rank, cases):
    """``spawn``'s ``fn`` of ``tests/test_torch_sharded_serve.py``: each
    case's greedy loop through ``launch.serve.make_jitted_serve_step`` on
    its (data, model) mesh of the group, from the JAX parameter tree it
    carries (numpy, fp32): the prompt stepped in, then the rank's own
    predictions; an encoder-decoder case first runs the one-rank
    ``prefill`` with its frames and splits that cache into blocks.
    Returns, by case: each step's predictions and logits for this rank's
    rows, the collective bytes of each step, the ``Gather`` forwards
    during the steps and after reading one parametrized leaf (the
    control), the cache's blocks after the steps, and the step's
    specs."""
    import dataclasses

    import repro_torch.configs as tconfigs
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as shd
    from repro_torch.models import convert
    from repro_torch.models.prefill import prefill
    out = {}
    for key, c in cases.items():
        cfg = dataclasses.replace(tconfigs.get_reduced(c["arch"]),
                                  param_dtype="float32", **c["cfg"])
        m = mesh._make(c["shape"], ("data", "model"))
        B, max_len = len(c["prompt"]), c["max_len"]
        lm = convert.params_from_jax(c["tree"], cfg, "cpu")
        prompt = torch.as_tensor(c["prompt"])
        p0 = 0
        if cfg.is_encoder_decoder:
            logits, whole, p0 = prefill(lm, {"tokens": prompt,
                                             "enc_media": c["enc_media"]},
                                        cfg, max_len)
            first = torch.argmax(logits[:, -1], dim=-1)
            cache = shd.shard_cache(whole, cfg, m)
            prompt = first[:, None]
        else:
            cache = shd.init_cache_blocks(cfg, m, B, max_len, device="cpu")
        lm = shd.shard_params(lm, m, fsdp=False)
        step, specs = serve.make_jitted_serve_step(cfg, m, B, max_len)
        offsets = torch.as_tensor(c["offsets"]) if c["offsets"] is not None \
            else 0
        spec = serve.token_spec(m, B)
        with mesh.bound(m):
            prompt = mesh.block(prompt, spec)
        shd.reset_gathers()
        rec = dict(next=[], logits=[], comm_bytes=[], specs=specs)
        tok = prompt[:, 0]
        for t in range(c["steps"]):
            mesh.reset_comm()
            with mesh.bound(m):
                nxt, logits, cache = step(lm, cache, tok, p0 + t + offsets)
            rec["comm_bytes"].append(dict(mesh.comm_bytes))
            rec["next"].append(nxt)
            rec["logits"].append(logits)
            tok = prompt[:, t + 1] if t + 1 < prompt.shape[1] else nxt
        rec["gathers"] = shd.gathers["forward"]
        with mesh.bound(m):
            lm.embed                      # the control: one parametrized read
        rec["gathers_after_a_read"] = shd.gathers["forward"]
        rec["next"] = torch.stack(rec["next"])
        rec["logits"] = torch.stack(rec["logits"])
        rec["cache"] = cache
        out[key] = rec
    return out


def admm_comm(rank, cases):
    """Each case's fit through ``decentral.build_sharded_admm`` on the
    ("node",) mesh of the group, one node a rank: {case: the fit's
    collective bytes by op (``mesh.comm_bytes``)}."""
    from repro_torch.core.admm import ADMMConfig
    out = {}
    for key, c in cases.items():
        X, y, W = (torch.as_tensor(c[k]) for k in ("X", "y", "W"))
        m, _, p = X.shape
        cfg = ADMMConfig(lam=0.01, h=0.1, max_iter=c["max_iter"])
        fitted = dec.build_sharded_admm(m, p, cfg, mesh.make_node_mesh(),
                                        c["schedule"])
        mesh.reset_comm()
        fitted(X, y, W, W.sum(1), torch.ones(m), torch.ones(p))
        out[key] = dict(mesh.comm_bytes)
    return out


def dry_cases(rank, train, serve, admm):
    """``spawn``'s ``fn`` of ``tests/test_torch_dryrun.py``: the real steps
    whose collective bytes the dry runs are held to, in one group —
    ``sharded_train``'s ``train`` cases, ``sharded_serve``'s ``serve``
    cases and ``admm_comm``'s ``admm`` cases."""
    return dict(train=sharded_train(rank, train),
                serve=sharded_serve(rank, serve), admm=admm_comm(rank, admm))


def _fit_request(d, rid, key, **kw):
    """A fit request of ``tests/test_torch_fit_serving_ranks.py`` on the
    inputs ``d[key]`` = (X, y, W, rho), with JAX's rho."""
    from repro_torch.serving import FitRequest
    X, y, W, rho = d[key]
    return FitRequest(rid=rid, X=X, y=y, W=W, rho=rho, **kw)


def fit_serving(rank, d):
    """``spawn``'s ``fn`` of ``tests/test_torch_fit_serving_ranks.py``:
    one ``DecsvmFitServer`` a rank on the CPU.  Rank 0 serves, in order:
    the chunked request and the dense one by ``run()`` (JAX's
    auto-routing test), a bucket that raises on every rank (an unknown
    penalty, found after the path) and the next request, then a warm and
    an LLA request through the worker, and stops.  The others try
    ``submit`` (it raises), then follow.  Each rank returns its results,
    bucket log keys, bucket records (``ranks.BucketRecorder``) and what
    raised; rank 0 also its state after ``stop()``."""
    from repro_torch.launch import ranks
    from repro_torch.serving import DecsvmFitServer
    srv = DecsvmFitServer(device="cpu")
    out = dict(rank=rank, errors={})
    cfg = core.ADMMConfig(lam=0.0, max_iter=30)
    base = dict(cfg=cfg, lams=d["lams"], mode="batched")
    with ranks.BucketRecorder("cpu") as rec:
        if rank == 0:
            srv.submit(_fit_request(d, 1, "ring", **base))
            srv.submit(_fit_request(d, 2, "head", **base))
            results = srv.run()
            h = srv.submit(_fit_request(d, 5, "ring", **base,
                                        penalty="not-a-penalty"))
            for what, call in (("run", srv.run), ("handle", h.result)):
                try:
                    call()
                except KeyError as err:
                    out["errors"][what] = repr(err)
            srv.submit(_fit_request(d, 6, "ring", **base))
            results.update(srv.run())
            srv.start()
            hs = [srv.submit(_fit_request(
                      d, 3, "ring", cfg=core.ADMMConfig(lam=0.0, max_iter=60),
                      lams=d["lams_warm"], mode="warm", tol=d["warm_tol"])),
                  srv.submit(_fit_request(d, 4, "ring", **base,
                                          penalty="scad", threshold=True))]
            results.update((h.rid, h.result(timeout=120)) for h in hs)
            srv.stop()
            out.update(pending=srv.pending, utilization=srv.utilization)
        else:
            try:
                srv.submit(_fit_request(d, 0, "head", **base))
            except RuntimeError as err:
                out["errors"]["submit"] = str(err)
            results = srv.follow()
    out.update(results=results, keys=[key for key, _ in srv.bucket_log],
               buckets=rec.buckets)
    return out


def _one_chunked_request(rank, d):
    from repro_torch.serving import DecsvmFitServer
    srv = DecsvmFitServer(device="cpu")
    if rank:
        return srv.follow()
    srv.submit(_fit_request(d, 1, "ring", cfg=core.ADMMConfig(
        lam=0.0, max_iter=30), lams=d["lams"], mode="batched"))
    try:
        return srv.run()
    finally:
        srv.stop()


def fit_serving_hang(rank, d):
    """``spawn``'s ``fn``: rank 0 serves a chunked request while rank 1
    never follows."""
    if rank == 1:
        import time
        time.sleep(3600)
    return _one_chunked_request(rank, d)


def fit_serving_alone(rank, d):
    """``spawn``'s ``fn``: rank 1 alone fails a chunked bucket after its
    last exchange (building its results); rank 0 prints what it raised."""
    from repro_torch.serving import fit
    if rank == 1:
        def fails(*args, **kw):
            raise ValueError("rank 1 fails alone")
        fit.DecsvmFitServer._result = fails
    try:
        return _one_chunked_request(rank, d)
    except fit.RanksDiverged as err:
        print(f"rank {rank} refused: {err}", flush=True)
        raise


def fit_serving_on_card(rank, s):
    """``spawn``'s ``fn`` on the card: rank 0 serves the chunked request
    of ``ranks.fit_requests(s)`` under ``megakernel``, the other ranks
    follow (``ranks.serve_requests``)."""
    from repro_torch.launch import ranks
    sync = ranks.fit_requests(s, "megakernel")[0][:1] if rank == 0 else ()
    return ranks.serve_requests(sync, (), s.device)
