"""Where the serving path's time goes on the card: one block prefill and a
few decode steps of a full-width model under ``torch.profiler``.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_serve
    PYTHONPATH=src python3 -m repro_torch.launch.profile_serve \
        --arch mamba2_370m --prompt 1999

    PYTHONPATH=src python3 -m repro_torch.launch.profile_serve \
        --arch seamless_m4t_large_v2 --prompt 1000 --batch 4

``--arch`` names the configuration (qwen3-14b by default; any family the
port serves).  The shapes are those of ``chip_smoke.py``'s serving runs: a
prefill of ``--batch`` prompts (1 by default) of ``--prompt`` tokens (1023
by default), and decode steps of 4 slots at that position over a
2048-long cache.  An encoder-decoder's prompts each carry their own
frames (``enc_media``, (frontend_len, d_model) from seed 2), so its
prefill runs the encoder, and its decode cache holds the cross K/V of 4
such inputs (``build_cross_cache``).  For each phase it prints the host
wall time (synchronized; without and with the profiler), the device time
(the sum of the kernels' times, one stream), the device's idle share
within the profiled run (1 - device / wall), the number of kernel
launches, and the kernels that take the most device time, one JSON row
per phase.  The weights are random (seed 0), the tokens random (seed 1).
Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model
from repro_torch.models.prefill import prefill

PROMPT, BATCH, MAX_LEN, STEPS = 1023, 4, 2048, 8


def _kernels(prof):
    """(name, device microseconds) of every kernel the profiler saw."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == cuda]


def _wall_ms(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _phase(label, fn, reps):
    """Time ``reps`` calls of ``fn`` after one warm-up, then profile as
    many: the idle share is taken within the profiled run."""
    fn()
    unprofiled = _wall_ms(fn, reps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = _wall_ms(fn, reps)
    kernels = _kernels(prof)
    device = sum(us for _, us in kernels) / 1e3 / reps
    by_name = collections.Counter()
    for name, us in kernels:
        by_name[name] += us / 1e3 / reps
    row = dict(phase=label, wall_ms_unprofiled=unprofiled,
               wall_ms=wall, device_ms=device,
               idle_share=1.0 - device / wall,
               launches=len(kernels) / reps,
               top=[(name[:90], ms) for name, ms in by_name.most_common(8)])
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_14b",
                    help="configuration to profile (default qwen3_14b)")
    ap.add_argument("--prompt", type=int, default=PROMPT,
                    help=f"prompt length (default {PROMPT})")
    ap.add_argument("--batch", type=int, default=1,
                    help="prompts in the prefill, lockstep (default 1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    cfg = configs.get(args.arch)
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name}: {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.param_dtype}", flush=True)
    params = model.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt))
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        frames = torch.randn(
            (max(args.batch, BATCH), cfg.frontend_len, cfg.d_model),
            generator=gen, device="cuda").to(params.embed.dtype)
        batch["enc_media"] = frames[:args.batch]
    _phase(f"prefill_B{args.batch}_S{args.prompt}",
           lambda: prefill(params, batch, cfg, MAX_LEN), 2)
    cache = model.init_cache(cfg, BATCH, MAX_LEN, device="cuda")
    if cfg.is_encoder_decoder:
        cache["cross_kv"] = model.build_cross_cache(params, frames[:BATCH],
                                                    cfg)
    token = torch.as_tensor(rng.integers(0, cfg.vocab_size, BATCH),
                            device="cuda")
    pos = torch.full((BATCH,), args.prompt, device="cuda")
    _phase(f"decode_B{BATCH}",
           lambda: model.decode_step(params, cache, token, pos, cfg), STEPS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
