"""Unified launcher, on the port's modules.

    PYTHONPATH=src python -m repro_torch.launch.cli train  --arch qwen3-14b --reduced --steps 50
    PYTHONPATH=src python -m repro_torch.launch.cli train  --arch qwen3-14b --ranks 4 --mesh 2x2 --batch 4 --seq 4096 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.cli serve  --arch mamba2-370m --reduced
    PYTHONPATH=src python -m repro_torch.launch.cli serve  --arch qwen3-32b --ranks 4 --mesh 1x4,2x2 --batch 8 --prompt-len 64 --max-new 64 --max-len 4096 --check
    PYTHONPATH=src python -m repro_torch.launch.cli decsvm --p 100 --m 10
    PYTHONPATH=src python -m repro_torch.launch.cli dryrun --arch qwen3-14b --shape decode_32k --mesh single

Counterpart of ``repro.launch.cli``; every subcommand takes ``--device``
(the card unless ``--device cpu``).  ``serve`` runs ``ServeEngine`` on
one card, or with ``--ranks`` the sharded serve step on that many ranks
(``launch.serve.serve_ranks``: tensor-parallel decode over "model", a
lockstep greedy loop, a line a rank; ``--check`` holds the logits
against the one-card step).  ``dryrun`` runs ``launch.dryrun.main``
in this process (JAX's launcher starts a subprocess for its XLA flag;
the port has none): one rank's step of each combination on meta
tensors, no card needed, a JSON record each under ``--out``.
"""
from __future__ import annotations

import argparse


def _cfg(args):
    import repro_torch.configs as configs
    return (configs.get_reduced(args.arch) if args.reduced
            else configs.get(args.arch))


def _mesh_arg(text: str):
    return tuple(int(x) for x in text.lower().split("x"))


def _serve_meshes(text: str):
    from repro_torch.launch.serve import mesh_arg
    return mesh_arg(text)


def cmd_train(args) -> None:
    from repro_torch.launch.train import train_loop
    train_loop(_cfg(args), steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, device=args.device, ranks=args.ranks,
               mesh=args.mesh)


def cmd_serve(args) -> None:
    import numpy as np
    from repro_torch.models import model
    from repro_torch.serving import Request, ServeEngine
    cfg = _cfg(args)
    if args.ranks > 1 or args.mesh is not None:
        from repro_torch.launch.serve import serve_ranks
        serve_ranks(cfg, ranks=args.ranks, mesh=args.mesh, batch=args.batch,
                    prompt_len=args.prompt_len, max_new=args.max_new,
                    max_len=args.max_len, device=args.device,
                    check=args.check, profile=args.profile, tol=args.tol)
        return
    params = model.init_params(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, params, max_batch=args.batch,
                      max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab_size,
                                               args.prompt_len).tolist(),
                           max_new=args.max_new))
    done = eng.run()
    print(f"completed {len(done)} requests; "
          f"sample: {done[0].generated[:8]}")


def cmd_decsvm(args) -> None:
    import numpy as np
    from repro_torch.core import (ADMMConfig, decsvm_fit, generate, losses,
                                  metrics, SimConfig)
    from repro_torch.core.graph import make_graph
    cfg = SimConfig(p=args.p, s=args.s, m=args.m, n=args.n)
    X, y, bstar = generate(cfg, seed=args.seed)
    W = make_graph(args.graph, cfg.m, cfg.p_connect, args.seed)
    h = losses.default_bandwidth(cfg.n_total, cfg.p)
    lam = 1.2 * float(np.sqrt(np.log(cfg.p) / cfg.n_total))
    B = decsvm_fit(X, y, W, ADMMConfig(lam=lam, h=h, max_iter=args.iters),
                   device=args.device)
    B = B.cpu().numpy()
    print(f"est.err={metrics.estimation_error(B, bstar):.4f} "
          f"F1={metrics.mean_f1(B, bstar, tol=1e-3):.3f} "
          f"consensus={metrics.consensus_gap(B):.2e} "
          f"supp={metrics.mean_support_size(B, 1e-3):.1f}")


def cmd_dryrun(args) -> None:
    from repro_torch.launch import dryrun
    argv = []
    for flag in ("arch", "shape", "mesh", "variant", "out"):
        v = getattr(args, flag, None)
        if v:
            argv += [f"--{flag}", str(v)]
    if args.all:
        argv.append("--all")
    dryrun.main(argv)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--arch", default="qwen3-14b")
    t.add_argument("--reduced", action="store_true")
    t.add_argument("--full", dest="reduced", action="store_false",
                   help="the registry's configuration (the default)")
    t.add_argument("--ranks", type=int, default=1)
    t.add_argument("--mesh", type=_mesh_arg, default=None,
                   help="(data)x(model) sizes, e.g. 2x2")
    t.add_argument("--steps", type=int, default=50)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--seq", type=int, default=128)
    t.add_argument("--lr", type=float, default=1e-3)
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("serve")
    s.add_argument("--arch", default="qwen3-14b")
    s.add_argument("--reduced", action="store_true")
    s.add_argument("--batch", type=int, default=4)
    s.add_argument("--max-len", dest="max_len", type=int, default=128)
    s.add_argument("--requests", type=int, default=8)
    s.add_argument("--prompt-len", dest="prompt_len", type=int, default=8)
    s.add_argument("--max-new", dest="max_new", type=int, default=8)
    s.add_argument("--ranks", type=int, default=1)
    s.add_argument("--mesh", type=_serve_meshes, default=None,
                   help="(data)x(model) sizes, e.g. 1x4, or several: "
                        "1x4,2x2 (with --ranks)")
    s.add_argument("--check", action="store_true",
                   help="with --ranks: the logits against the one-card step")
    s.add_argument("--profile", type=int, default=0,
                   help="with --ranks: profile the last N steps")
    s.add_argument("--tol", type=float, default=None,
                   help="with --check: the limit of the logits' max|dev|")
    s.set_defaults(fn=cmd_serve)

    d = sub.add_parser("decsvm")
    d.add_argument("--p", type=int, default=100)
    d.add_argument("--s", type=int, default=10)
    d.add_argument("--m", type=int, default=10)
    d.add_argument("--n", type=int, default=200)
    d.add_argument("--graph", default="erdos_renyi")
    d.add_argument("--iters", type=int, default=300)
    d.add_argument("--seed", type=int, default=0)
    d.set_defaults(fn=cmd_decsvm)

    r = sub.add_parser("dryrun")
    r.add_argument("--arch", default=None)
    r.add_argument("--shape", default=None)
    r.add_argument("--mesh", default="single")
    r.add_argument("--variant", default=None)
    r.add_argument("--out", default="results/dryrun")
    r.add_argument("--all", action="store_true")
    r.set_defaults(fn=cmd_dryrun)

    for p in (t, s, d):
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
