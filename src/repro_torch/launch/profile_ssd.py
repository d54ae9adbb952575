"""Where ``ssd_scan``'s time goes on the card: the tensor-core instance's
three passes at mamba2-370m's prefill shapes, for each head group.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_ssd
    PYTHONPATH=src python3 -m repro_torch.launch.profile_ssd --prompts 1999

For each prompt length (2048 and 1023 by default) and head group (1, 2, 4
heads per block of the chunk and output passes; ``ops.ssd_head_group``
picks one for the wrapper) it prints one JSON row: the device time of a
call (CUDA events around replays of a CUDA graph of the call), each
pass's device time (``torch.profiler``), whether y and the final state
equal group 1's bit for bit, and the host time of one call from Python
(back-to-back calls of ``ops.ssd_scan``, not synchronized).  Inputs are
drawn as the model forms them (x, B, C column slices of one silu'd conv
output, dt = softplus(N), A = -linspace(1, 16, h), D = 1; seed = S).
Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from repro_torch.kernels import ops

H, P, N, CHUNK = 32, 64, 128, 64


def _inputs(S: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S)
    f32 = dict(generator=gen, device="cuda", dtype=torch.float32)
    buf = torch.nn.functional.silu(
        0.5 * torch.randn((1, S, H * P + 2 * N), **f32)).to(torch.bfloat16)
    x = buf[..., :H * P].reshape(1, S, H, P)
    B, C = buf[..., H * P:H * P + N], buf[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((1, S, H), **f32))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    D = torch.ones(H, device="cuda")
    return x, dt, A, B, C, D


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn``: CUDA events around ``reps``
    replays of a CUDA graph of the call (captured after a warm-up call on a
    side stream).  Unlike events around back-to-back calls it holds no host
    time, which exceeds a short kernel's (the SSD wrapper's Python and its
    three launches take tens of microseconds a call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _passes_us(fn, reps: int):
    """{kernel: device microseconds a call} under the profiler (named
    without the return type, anonymous namespace and parameter list)."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.events():
        if e.device_type == cuda:
            name = e.name.replace("(anonymous namespace)::", "")
            out[name.split("(")[0].removeprefix("void ")] += (
                e.time_range.elapsed_us() / reps)
    return dict(out)


def _host_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompts", type=int, nargs="+", default=[2048, 1023])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssd: needs a CUDA device")
    for S in args.prompts:
        inputs = _inputs(S)
        first = None
        for group in (1, 2, 4):
            call = (lambda g=group: ops._ssd_launch(*inputs, CHUNK, "wgmma",
                                                    group=g))
            out = call()
            first = first or out
            row = dict(
                S=S, group=group,
                rule_group=ops.ssd_head_group(1, S, H, CHUNK),
                device_ms=graph_ms(call, 50),
                passes_us=_passes_us(call, 5),
                same_bits_as_group_1=bool(torch.equal(out[0], first[0])
                                          and torch.equal(out[1], first[1])))
            print(json.dumps(row), flush=True)
        print(json.dumps(dict(
            S=S, host_us_per_call=_host_us(
                lambda: ops.ssd_scan(*inputs, chunk=CHUNK), 200),
            fma_device_ms=graph_ms(
                lambda: ops._ssd_launch(*inputs, CHUNK, "fma"), 10),
            device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
