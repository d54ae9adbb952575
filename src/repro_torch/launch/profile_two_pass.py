"""Where the two-pass CSVM update's time goes on the card: each instance of
``csvm_block_update`` at the fit's main-path shape, and the stream
instance's grid.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_two_pass
    PYTHONPATH=src python3 -m repro_torch.launch.profile_two_pass --shape 10 200 101

For fp32 and bf16 X it prints one JSON row per instance (and per grid of
the stream instance: the rule's, half of it and twice it): the device time
of a call (CUDA events around replays of a CUDA graph of the call), each
kernel's device time (``torch.profiler``), the effective rate of X's
bytes, and the host time of one call from Python (back-to-back calls of
the wrapper, not synchronized).  Inputs are seeded (seed 0) standard
normal X, labels of +-1, and iterates of the fit's scale.  Needs a card.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import ops
from repro_torch.launch.profile_ssd import _host_us, _passes_us, graph_ms


def _inputs(m: int, n: int, p: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    f32 = dict(generator=gen, device="cuda", dtype=torch.float32)
    X = torch.randn((m, n, p), **f32)
    y = torch.sign(torch.randn((m, n), **f32))
    B = 0.05 * torch.randn((m, p), **f32)
    P = 0.01 * torch.randn((m, p), **f32)
    neigh = 0.05 * torch.randn((m, p), **f32)
    rho = torch.full((m,), 0.5 * p, device="cuda")
    omega = 1.0 / (rho + 2.0 * m)
    lam = torch.full((p,), 0.01, device="cuda")
    return X, (y, B, P, neigh, rho, omega, lam)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=[16, 1024, 4096],
                    metavar=("M", "N", "P"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_two_pass: needs a CUDA device")
    m, n, p = args.shape
    X32, rest = _inputs(m, n, p)
    for X in (X32, X32.to(torch.bfloat16)):
        rule = ops.two_pass_grid(X.device, m, n, p, X.dtype)
        runs = [("direct", None)] + [("stream", g) for g in sorted(
            {rule, max(1, rule // 2), min(m * n, 2 * rule)})]
        for instance, grid in runs:
            call = (lambda i=instance, g=grid: ops._two_pass_launch(
                "csvm_block_update", X, *rest, i, h=0.3, grid=g))
            call()
            ms = graph_ms(call, 20)
            reads = 2 if instance == "direct" else 1
            print(json.dumps(dict(
                X=[m, n, p], dtype=str(X.dtype).replace("torch.", ""),
                instance=instance, grid=grid, rule_grid=rule,
                device_ms=ms, kernels_us=_passes_us(call, 5),
                x_tbs=reads * X.numel() * X.element_size() / ms / 1e9)),
                flush=True)
        print(json.dumps(dict(
            dtype=str(X.dtype).replace("torch.", ""),
            host_us_per_call=_host_us(
                lambda: ops.csvm_block_update(X, *rest, h=0.3), 200),
            device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
