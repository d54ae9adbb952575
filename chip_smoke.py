#!/usr/bin/env python3
"""GPU smoke run of the torch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases (each prints its lines; any failure exits non-zero before the
result lines):

1. the card: ``nvidia-smi`` name and power limit, TF32 switched off;
2. the build: ``nvcc`` compiles the CUDA sources of the port, one process
   per source, all at once; ptxas's registers and spills per kernel (and
   shared memory of the round kernel's stream instance), the wgmma (HGMMA)
   and TMA-load (UTMALDG) instructions ``cuobjdump -sass`` finds in the
   tensor-core flash instance and the bulk copies (UBLKCP) in the stream
   instance of ``csvm_round_block`` (none fails the run);
3. the CSVM kernels: each against its plain torch version on the card,
   at the paper's design size and at the full size below, in fp32 and
   bf16, with held rounds, ``nact = 0``, lambda vectors and
   ``lam0 > 0`` — ``csvm_round_block`` on both its instances (``stream``,
   one read of X a round, and ``direct``, the earlier design); then their
   times (CUDA events) beside the plain versions' and the bound, the round
   kernel's two instances in turns with their effective TB/s and the
   floor of one read of X a round (the stream instance must take at most
   0.6x the direct one's time);
4. the fit path at full size — ``SimConfig(p=4095, s=10, m=16, n=1024,
   rho=0.5)`` on ``erdos_renyi(16, 0.5, seed=0)``, X (16, 1024, 4096):
   ``decsvm_fit`` under ``megakernel`` (with and without
   ``track_history``) and ``pallas``, ``decsvm_fit_tol`` (KKT stop) under
   ``megakernel_bf16``, each against the plain ``jnp`` backend on the
   card, with the launch counters read around the fits (every
   ``csvm_round_block`` launch on the stream instance); the KKT fits
   must stop before ``max_iter`` and within one check block of each
   other;
5. ``flash_attention`` against its plain version (``ref.mha``) at the
   shapes of ``tests/test_kernels.py`` (every mask, MQA, D = 32/64/128,
   ragged S), at qwen3-14b's (q (1, 40, S, 128), kv (1, 8, S, 128),
   S = 1023 and 2048, causal, fed as the model's strided views) and at
   the edges of the tensor-core instance (windows, no mask, B = 2 at a
   ragged S, S < 128, D = 64), fp32 and bf16, each case on the instance
   ``ops.flash_instance`` names (bf16 at D = 64/128: tensor cores; the
   rest: fp32 FMAs); then its times beside the plain version's, the
   bound, the fp32-FMA instance's and ``scaled_dot_product_attention``'s
   (timed only, never on the path);
6. the serving path at full width — qwen3-14b (40 layers, d_model 5120,
   bf16, random weights from seed 0) in ``ServeEngine(max_batch=4,
   max_len=2048, block_prefill=True)``: 8 requests of ragged prompt
   lengths, 16 new tokens each, with the launch counters read around the
   run (40 flash launches per prefilled request, every one on the
   tensor-core instance);
7. the kernel against the plain attention inside the model: block-prefill
   logits of a 1023-token prompt at full width in bf16, with 2 layers in
   fp32, and in the reduced config (D = 64, group 2) in bf16;
8. ``ssd_scan`` against its plain version (``ref.ssd_scan``) at the
   shapes of ``tests/test_kernels.py`` and at mamba2-370m's (x (1, S, 32,
   64), B and C (1, S, 128), S = 1023, 1999 and 2048, fed as the model's
   strided slices of one conv output), fp32 and bf16, y and the final
   state; then its times beside the plain version's and the bound (no
   single torch call computes the scan: no library time);
9. the serving path at full width — mamba2-370m (48 layers, d_model 1024,
   bf16, random weights from seed 0) in the same engine and with the same
   8 requests, with the launch counters read around the run (48
   ``ssd_scan`` launches per prefilled request, no ``flash_attention``);
10. the kernel against the plain scan inside the model: block-prefill
   logits and the seeded SSM state of a 1999-token prompt (prime, so the
   last chunk is ragged), with all 48 layers in bf16 and with 2 layers in
   fp32.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 without the
# tensor cores, bf16 on the tensor cores, device-memory bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# A kernel against its plain version on the same inputs.  fp32: the same
# fp32 arithmetic summed in another order (the repo's fp32 tier).  bf16:
# both sides round B, w and beta_bar to bf16 at the same points, so they
# differ only where an fp32 summation-order difference moves an operand
# across a bf16 rounding boundary; measured on an H100 at the shapes below:
# 2.2e-5 (csvm_round_block, bf16 X (16, 1024, 4096), 5 rounds + KKT) and
# 3e-8 (the two-pass kernels).  The limit holds a few such flips and is
# 100x below the fit tier.
TOL = {"float32": 1e-5, "bfloat16": 1e-4}
# A fit against the plain fp32 fit on the card, the repo's tiers
# (tests/test_solver.py): fp32 1e-5; bf16 1e-2 with sign-exact support on
# |B| > 1e-2 (bf16 X changes the estimator itself).
FIT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# decsvm_fit_tol's KKT stop level: the plain fp32 fit at full size reaches
# it after a little more than half of its 300 rounds (the stopping rounds
# are printed), so the stopping round itself is decided and compared on
# the card.
KKT_TOL = 3e-2
CHECK_EVERY = 4         # decsvm_fit_tol's default check interval

# flash_attention against its plain version.  fp32: the repo's kernel
# tier (tests/test_kernels.py:86).  bf16: both sides read the same bf16
# inputs, compute in fp32 and round the output once, so they may differ by
# one bf16 ulp of the output: |dev| <= 2^-7 |o_plain| + 1e-6.
FLASH_TOL_F32 = 2e-5
BF16_ULP = 2.0 ** -7
# (B, H, KV, S, D, causal, window): tests/test_kernels.py:75-105, then
# qwen3-14b's attention at the prompt lengths of the kernel table, then the
# edges of the tensor-core instance (bf16 at D = 64 and 128): windows of 64
# and 17, no mask, a batch of 2 at a ragged S, S below one 128-row q tile,
# and D = 64 at group 2 (the reduced dense configs)
FLASH_CASES = [
    (1, 2, 2, 128, 64, True, None), (2, 4, 2, 256, 64, True, None),
    (1, 4, 1, 128, 32, True, None), (1, 8, 2, 200, 64, True, None),
    (1, 14, 2, 128, 64, True, None), (1, 10, 1, 128, 128, True, None),
    (1, 4, 2, 160, 32, True, None), (1, 4, 2, 160, 32, False, None),
    (1, 4, 2, 160, 32, True, 64), (1, 4, 2, 160, 32, True, 17),
    (1, 40, 8, 1023, 128, True, None), (1, 40, 8, 2048, 128, True, None),
    (1, 8, 2, 300, 128, True, 64), (1, 8, 2, 300, 128, True, 17),
    (1, 8, 2, 300, 128, False, None), (2, 8, 2, 333, 128, True, None),
    (1, 8, 2, 100, 128, True, None), (1, 8, 4, 333, 64, True, None),
]
# The serving path: qwen3-14b at full width, ragged prompts (none a
# multiple of the 64-row tile), 16 new tokens each.
SERVE_PROMPTS = (2000, 1500, 1023, 777, 500, 257, 129, 64)
SERVE_NEW = 16
SERVE_BATCH, SERVE_LEN = 4, 2048
# Block-prefill logits with the kernel against the plain attention inside
# the model, one 1023-token prompt (random weights, seed 0; logits up to
# ~8.7).  fp32 (2 layers): the kernel's fp32 summation order through two
# layers and the LM head; measured 3.05e-5 on an H100.  bf16 (40 layers):
# one-ulp differences of each layer's attention output, carried and
# amplified through 40 layers of bf16 rounding; measured 0.361 on an H100
# (the same bits from run to run: the kernel and the products are
# deterministic).  Each limit is about 3x its measured deviation.
MODEL_PROMPT = 1023
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1.0}

# ssd_scan against its plain version.  fp32: the repo's SSD tier
# (tests/test_kernels.py:120); the two sum the cumulative decays in the
# same order and differ only in the order of the other fp32 sums.  bf16:
# both widen the same bf16 x, B, C exactly, compute in fp32 and round y
# once, so y may differ by one bf16 ulp (the flash limit).  The final
# state is fp32 on both sides: within 5e-5 (1 + |s_plain|), the fp32 tier
# relative to the state's size.
SSD_TOL_F32 = 5e-5
# (b, s, h, p, n, chunk): tests/test_kernels.py:105-108, then mamba2-370m's
# scan at prompt lengths of the serving run (1999 is prime: ragged tail)
SSD_CASES = [
    (1, 64, 2, 8, 16, 32), (2, 128, 3, 16, 32, 64), (1, 96, 4, 32, 128, 32),
    (1, 128, 1, 8, 16, 128),
    (1, 1023, 32, 64, 128, 64), (1, 1999, 32, 64, 128, 64),
    (1, 2048, 32, 64, 128, 64),
]
# Block-prefill logits and the seeded SSM state with the kernel against
# the plain scan inside mamba2-370m, one 1999-token prompt (random weights,
# seed 0; logits up to ~3.7, states up to ~1.6).  fp32 (2 layers): the
# kernel's fp32 summation order through two layers and the LM head;
# measured 4.5e-6 (logits) and 3.6e-7 (state) on an H100, held to the
# flash phase's 1e-4.  bf16 (48 layers): one-ulp differences of each
# layer's y, carried and amplified through 48 layers of bf16 rounding;
# measured 0.148 (logits) and 0.0335 (state) on an H100.  The limit is
# about 3x the larger.
MAMBA_PROMPT = 1999
MAMBA_TOL = {"float32": 1e-4, "bfloat16": 0.5}

# csvm_round_block's stream instance (one read of X a round) against the
# direct one (two reads) in the same call, at both main-path shapes: at
# most this share of its time.
STREAM_RATIO = 0.6

FIT_KERNELS = ("csvm_local_update", "csvm_block_update", "csvm_round_block")
REPLACES = {
    "csvm_local_update": "src/repro/kernels/csvm_update.py:83",
    "csvm_block_update": "src/repro/kernels/csvm_update.py:349",
    "csvm_round_block": "src/repro/kernels/csvm_update.py:277",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:76",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/csvm_update.cu"
           for name in FIT_KERNELS}
SOURCES["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCES["ssd_scan"] = "src/repro_torch/kernels/csrc/ssd_scan.cu"


def log(*args):
    print(*args, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def _ptxas_entries(log_text: str):
    """(kernel<[type, ][int]>, its "Used ..." line, spills) per entry
    function of nvcc's ``-Xptxas -v`` output."""
    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '.*?\d+([a-z_]+_kernel)I"
                          r"(f|13__nv_bfloat16)?(?:Li(\d+)E)?E", line)
        if entry:
            args = []
            if entry.group(2):
                args.append("float" if entry.group(2) == "f" else "bf16")
            if entry.group(3):
                args.append(entry.group(3))
            name = f"{entry.group(1)}<{', '.join(args)}>"
        elif "spill" in line:
            spills = line.strip()
        elif re.search(r"Used \d+ registers", line) and name:
            out.append((name, line, spills))
            name = None
    return out


def ptxas_report(log_text: str):
    """(kernel<[type, ][int]>, registers, spills) per entry function of
    nvcc's ``-Xptxas -v`` output."""
    return [(name, int(re.search(r"Used (\d+) registers", used).group(1)),
             spills) for name, used, spills in _ptxas_entries(log_text)]


def ptxas_smem(log_text: str):
    """{kernel<...>: static shared memory bytes} of the same output (0
    where ptxas reports none)."""
    out = {}
    for name, used, _ in _ptxas_entries(log_text):
        smem = re.search(r"(\d+) bytes smem", used)
        out[name] = int(smem.group(1)) if smem else 0
    return out


def sass_counts(sass_text: str, opcodes=("HGMMA", "UTMALDG")):
    """{function: (count of each opcode)} of ``cuobjdump -sass`` output:
    by default the wgmma and TMA-load instructions each compiled kernel
    issues."""
    counts, fn = {}, None
    for line in sass_text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = [0] * len(opcodes)
        elif fn is not None:
            for i, op in enumerate(opcodes):
                counts[fn][i] += op in line
    return {fn: tuple(c) for fn, c in counts.items()}


def disassemble(build, name: str) -> str:
    """``cuobjdump -sass`` of the library built from source ``name``."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-2000:]}")
    return sass.stdout


def tensor_core_sass(build):
    """Disassemble the flash library and check that the tensor-core
    instance (``flash_tc_kernel`` at D = 64 and 128) issues wgmma and TMA
    loads; returns {D: (HGMMA, UTMALDG)}."""
    found = {}
    for fn, (hgmma, utmaldg) in sass_counts(
            disassemble(build, "flash_attention")).items():
        inst = re.search(r"flash_tc_kernelILi(\d+)E", fn)
        if inst:
            found[int(inst.group(1))] = (hgmma, utmaldg)
            log(f"sass flash_tc_kernel<{inst.group(1)}>: {hgmma} HGMMA, "
                f"{utmaldg} UTMALDG")
    check(set(found) == {64, 128} and all(
        h > 0 and u > 0 for h, u in found.values()),
        f"the tensor-core flash instance issues no wgmma or TMA load: "
        f"{found}")
    return found


def bulk_copy_sass(build):
    """Disassemble the CSVM library and check that the stream instance of
    the round kernel (``round_stream_kernel`` for fp32 and bf16 X) issues
    TMA bulk copies (UBLKCP; UTMALDG with a tensor map); returns
    {dtype: (UBLKCP, UTMALDG)}."""
    found = {}
    for fn, (blk, tma) in sass_counts(disassemble(build, "csvm_update"),
                                      ("UBLKCP", "UTMALDG")).items():
        inst = re.search(r"round_stream_kernelI(f|13__nv_bfloat16)E", fn)
        if inst:
            dtype = "float32" if inst.group(1) == "f" else "bfloat16"
            found[dtype] = (blk, tma)
            log(f"sass round_stream_kernel<{dtype}>: {blk} UBLKCP, {tma} "
                "UTMALDG")
    check(set(found) == {"float32", "bfloat16"} and all(
        b + u > 0 for b, u in found.values()),
        f"the stream round kernel issues no bulk copy: {found}")
    return found


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` on the card by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(torch, kernel, plain, reps: int, plain_reps: int):
    """A kernel and its plain version timed in turns — kernel, plain,
    plain, kernel — so that drift on the card hits both alike.  Returns
    the two means and the two samples of each."""
    k1 = cuda_ms(torch, kernel, reps)
    p1 = cuda_ms(torch, plain, plain_reps)
    p2 = cuda_ms(torch, plain, plain_reps)
    k2 = cuda_ms(torch, kernel, reps)
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                ms_samples=[k1, k2], plain_ms_samples=[p1, p2])


def bound(flops: float, nbytes: float, peak_flops: float):
    """Least time the card could take: (ms, "operations" | "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return ((1e3 * t_ops, "operations") if t_ops >= t_bytes
            else (1e3 * t_bytes, "bytes"))


class Data:
    """One problem on the card: the simulated design, the network, and
    the per-node scalars, plus seeded iterates for the kernel checks."""

    def __init__(self, torch, core, sim, seed=0, device="cuda"):
        import numpy as np
        self.sim = sim
        X, y, self.beta_star = core.generate(sim, seed=seed)
        self.Xn, self.yn = X, y
        self.Wn = core.graph.erdos_renyi(sim.m, sim.p_connect, seed=0)
        self.lam = 1.2 * math.sqrt(math.log(sim.p) / sim.n_total)
        self.h = core.default_bandwidth(sim.n_total, sim.p)
        self.device = dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.X = torch.tensor(X, **f32)
        self.y = torch.tensor(y, **f32)
        self.W = torch.tensor(self.Wn, **f32)
        self.deg = self.W.sum(1)
        self.rho = core.compute_rho(self.X, self.h, "epanechnikov")
        self.lam0 = 0.05
        self.omega = 1.0 / (2.0 * self.deg + self.rho)
        self.omega0 = 1.0 / (2.0 * self.deg + self.rho + self.lam0)
        rng = np.random.default_rng(seed + 1)
        m, p = self.X.shape[0], self.X.shape[2]
        self.B = torch.tensor(rng.standard_normal((m, p)) * 0.05, **f32)
        self.P = torch.tensor(rng.standard_normal((m, p)) * 0.01, **f32)
        self.lam_vec = torch.tensor(
            self.lam * rng.uniform(0.5, 1.5, p), **f32)
        self.lam_flat = torch.full((p,), self.lam, **f32)
        self.neigh = 1.0 * (self.deg[:, None] * self.B + self.W @ self.B)
        self.X16 = self.X.to(torch.bfloat16)

    def x(self, dtype):
        return self.X if dtype == "float32" else self.X16


def compare(torch, got, want, dtype, what):
    """Max |got - want| over the tensors, +inf statistics matched exactly;
    bf16 also needs sign-exact support of B."""
    dev = 0.0
    for g, w in zip(got, want):
        if w.dim() == 0 and torch.isinf(w):
            check(bool(torch.isinf(g)) and float(g) > 0,
                  f"{what}: statistic {float(g)} where the plain version "
                  "gives +inf")
            continue
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
        dev = max(dev, float((g - w).abs().max()))
    if dtype == "bfloat16":
        supp = want[0].abs() > FIT_TOL["bfloat16"]
        check(torch.equal(torch.sign(got[0])[supp], torch.sign(want[0])[supp]),
              f"{what}: bf16 support signs differ")
    check(dev <= TOL[dtype], f"{what}: max |dev| {dev:.3e} > {TOL[dtype]}")
    return dev


def record(devs, name, dtype, dev):
    devs.setdefault(name, {})
    devs[name][dtype] = max(devs[name].get(dtype, 0.0), dev)


def kernel_checks(torch, ops, cu, d: Data, label: str, devs: dict):
    """Each kernel's wrapper on the card against its plain version."""
    nact_t = lambda k: torch.tensor(k, dtype=torch.int32, device=d.device)
    for dtype in ("float32", "bfloat16"):
        args = (d.x(dtype), d.y, d.B, d.P, d.neigh, d.rho, d.omega,
                d.lam_vec)
        got = (ops.csvm_block_update(*args, h=d.h),)
        want = (cu.csvm_block_update_plain(*args, h=d.h),)
        dev = compare(torch, got, want, dtype,
                      f"csvm_block_update {label} {dtype}")
        record(devs, "csvm_block_update", dtype, dev)
        log(f"check csvm_block_update {label} {dtype}: max|dev| {dev:.3e}")
    for kernel in ("epanechnikov", "laplacian"):
        args = (d.X, d.y, d.B, d.P, d.neigh, d.rho, d.omega, d.lam_vec)
        got = (ops.csvm_local_update(*args, h=d.h, kernel=kernel),
               ops.csvm_local_update(d.X[0], d.y[0], d.B[0], d.P[0],
                                     d.neigh[0], d.rho[0], d.omega[0],
                                     d.lam, h=d.h, kernel=kernel))
        plain = cu.csvm_local_update_plain(*args[:7], d.lam_flat, h=d.h,
                                           kernel=kernel)
        want = (cu.csvm_local_update_plain(*args, h=d.h, kernel=kernel),
                plain[0])
        dev = compare(torch, got, want, "float32",
                      f"csvm_local_update {label} {kernel}")
        record(devs, "csvm_local_update", "float32", dev)
        log(f"check csvm_local_update {label} {kernel} (stacked and one "
            f"node): max|dev| {dev:.3e}")
    # (dtype, num_rounds, nact, want_kkt, lam0, lambda vector)
    cases = [("float32", 5, 5, False, 0.0, False),
             ("float32", 5, 3, True, d.lam0, True),
             ("float32", 4, 0, False, 0.0, True),
             ("float32", 4, 0, True, d.lam0, False),
             ("float32", 6, 6, True, 0.0, True),
             ("bfloat16", 5, 5, True, d.lam0, True),
             ("bfloat16", 5, 2, False, 0.0, False),
             ("bfloat16", 4, 0, True, 0.0, True)]
    # on the card each case runs on both instances of the round kernel
    # (the wrapper's choice first); on the CPU the wrapper's plain version
    m, n, p = d.X.shape
    on_card = d.device.type == "cuda"
    for dtype, R, nact, kkt, lam0, vec in cases:
        omega = d.omega0 if lam0 else d.omega
        args = (d.x(dtype), d.y, d.B, d.P, d.W, d.deg, d.rho, omega,
                d.lam_vec if vec else d.lam_flat)
        kw = dict(tau=1.0, lam0=lam0, h=d.h, num_rounds=R, want_kkt=kkt)
        want = cu.csvm_round_block_plain(*args, nact, **kw)
        chosen = ops.round_block_instance(m, n, p, args[0].dtype)
        instances = ([chosen] + [i for i in ops.ROUND_INSTANCES
                                 if i != chosen]) if on_card else ["plain"]
        for instance in instances:
            before = dict(ops.round_block_launches)
            if instance == chosen:
                got = ops.csvm_round_block(*args, nact_t(nact), **kw)
            elif on_card:
                got = ops._round_block_launch(*args, nact_t(nact), instance,
                                              **kw)
            else:
                got = ops.csvm_round_block(*args, nact_t(nact), **kw)
            if on_card:
                ran = {k: v - before[k]
                       for k, v in ops.round_block_launches.items()}
                check(ran == {k: int(k == instance)
                              for k in ops.ROUND_INSTANCES},
                      f"csvm_round_block {label}: launched {ran}, expected "
                      f"one {instance} launch")
            what = (f"csvm_round_block [{instance}] {label} {dtype} "
                    f"rounds={R} nact={nact} kkt={kkt} lam0={lam0} "
                    f"lam_vector={vec}")
            dev = compare(torch, got, want, dtype, what)
            if nact == 0:
                check(torch.equal(got[0], d.B) and torch.equal(got[1], d.P),
                      f"{what}: held rounds changed B or P")
            record(devs, "csvm_round_block", dtype, dev)
            log(f"check {what}: max|dev| {dev:.3e} stat {float(got[2]):.6g}"
                f" (plain {float(want[2]):.6g})")


def kernel_timings(torch, ops, cu, d: Data, max_iter: int):
    """Times at the shapes the main path gives each kernel."""
    m, n, p = d.X.shape
    f = 4
    rows = {}
    args2 = (d.X, d.y, d.B, d.P, d.neigh, d.rho, d.omega, d.lam_vec)
    two_pass_bytes = (m * n * p * f + m * n * f + 3 * m * p * f + 2 * m * f
                      + p * f + m * p * f)
    for name, fn, plain in (
        ("csvm_block_update", ops.csvm_block_update,
         cu.csvm_block_update_plain),
        ("csvm_local_update", ops.csvm_local_update,
         cu.csvm_local_update_plain),
    ):
        times = paired_ms(torch, lambda: fn(*args2, h=d.h),
                          lambda: plain(*args2, h=d.h), 20, 20)
        bms, by = bound(4 * m * n * p, two_pass_bytes, PEAK_FP32)
        rows[name] = dict(times, bound_ms=bms, bound_by=by,
                          shape=f"X ({m}, {n}, {p}) fp32, one round")
    variants = []
    on_card = d.device.type == "cuda"
    for dtype, R, kkt in (("float32", max_iter, False),
                          ("bfloat16", 4, True)):
        args = (d.x(dtype), d.y, d.B, d.P, d.W, d.deg, d.rho, d.omega,
                d.lam_flat)
        kw = dict(tau=1.0, lam0=0.0, h=d.h, num_rounds=R, want_kkt=kkt)
        nact = torch.tensor(R, dtype=torch.int32, device=d.device)
        reps = 3 if R > 10 else 20
        instance = ops.round_block_instance(m, n, p, args[0].dtype)
        check(instance == "stream", f"csvm_round_block at X ({m}, {n}, {p})"
              f" {dtype} takes the {instance} instance, not the stream one")
        kernel = lambda: ops.csvm_round_block(*args, nact, **kw)
        plain = lambda: cu.csvm_round_block_plain(*args, R, **kw)
        # in turns: stream, direct, plain, plain, direct, stream
        k1 = cuda_ms(torch, kernel, reps)
        earlier = (lambda: ops._round_block_launch(*args, nact, "direct",
                                                   **kw)) if on_card else None
        e1 = cuda_ms(torch, earlier, reps) if earlier else None
        p1 = cuda_ms(torch, plain, max(1, reps // 3))
        p2 = cuda_ms(torch, plain, max(1, reps // 3))
        e2 = cuda_ms(torch, earlier, reps) if earlier else None
        k2 = cuda_ms(torch, kernel, reps)
        times = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                     ms_samples=[k1, k2], plain_ms_samples=[p1, p2])
        isz = 4 if dtype == "float32" else 2
        nbytes = (ops.round_block_bytes(m, n, p, isz, R)
                  - 4 * ops.round_block_scratch_floats(m, n, p, R))
        # the margins and X^T w of each round, and once more at beta_bar
        # for the KKT epilogue; the W@B sums (2 m^2 p a round) are left out
        passes = R + (1 if kkt else 0)
        flops = 4 * m * n * p * passes
        bms, by = bound(flops, nbytes,
                        PEAK_FP32 if dtype == "float32" else PEAK_BF16)
        # X must come from device memory once a pass: it does not fit on
        # the chip; the direct instance reads it twice a pass
        x_bytes = m * n * p * isz
        row = dict(times, bound_ms=bms, bound_by=by,
                   floor_ms=1e3 * passes * x_bytes / PEAK_BYTES,
                   stream_tbs=passes * x_bytes / times["ms"] / 1e9,
                   shape=f"X ({m}, {n}, {p}) {dtype}, {R} rounds, "
                         f"want_kkt={kkt}")
        if earlier:
            row.update(earlier_ms=(e1 + e2) / 2, earlier_ms_samples=[e1, e2],
                       earlier_tbs=2 * passes * x_bytes / ((e1 + e2) / 2)
                       / 1e9)
            row["ratio"] = row["ms"] / row["earlier_ms"]
        variants.append(row)
    rows["csvm_round_block"] = dict(variants[0], variants=variants[1:])
    for name, row in rows.items():
        for v in [row] + row.get("variants", []):
            log(f"time {name} [{v['shape']}]: {v['ms']:.4f} ms "
                f"(samples {v['ms_samples'][0]:.4f}, "
                f"{v['ms_samples'][1]:.4f}), plain {v['plain_ms']:.4f} ms "
                f"(samples {v['plain_ms_samples'][0]:.4f}, "
                f"{v['plain_ms_samples'][1]:.4f}), bound "
                f"{v['bound_ms']:.4f} ms ({v['bound_by']})")
    for v in [rows["csvm_round_block"]] + rows["csvm_round_block"]["variants"]:
        if "earlier_ms" not in v:
            continue
        log(f"time csvm_round_block instances [{v['shape']}]: stream "
            f"{v['ms']:.4f} ms ({v['stream_tbs']:.3f} TB/s, X once a pass),"
            f" direct {v['earlier_ms']:.4f} ms (samples "
            f"{v['earlier_ms_samples'][0]:.4f}, "
            f"{v['earlier_ms_samples'][1]:.4f}; {v['earlier_tbs']:.3f} TB/s,"
            f" X twice a pass), stream/direct {v['ratio']:.3f}; floor of one"
            f" read of X a pass {v['floor_ms']:.4f} ms, the guide's bound "
            f"{v['bound_ms']:.4f} ms")
        check(v["ratio"] <= STREAM_RATIO,
              f"csvm_round_block [{v['shape']}]: the stream instance takes "
              f"{v['ratio']:.3f}x the direct one's time, over {STREAM_RATIO}")
    return rows


def main_path(torch, core, ops, d: Data, max_iter: int = 300,
              kkt_tol: float = KKT_TOL):
    """The four fits at full size through the port's entry points, each
    held against the plain backend on the card; returns the launches."""
    import numpy as np
    sim = d.sim
    X, y, W = d.Xn, d.yn, d.Wn
    on = dict(device=d.device)

    def cfg(backend):
        return core.ADMMConfig(lam=d.lam, h=d.h, max_iter=max_iter,
                               backend=backend)

    def timed(fn):
        synchronize(torch, d.device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(torch, d.device)
        return out, time.perf_counter() - t0

    def report(name, B, secs, ref=None, tol=None):
        Bn = B.detach().cpu().numpy()
        check(Bn.shape == (sim.m, sim.p + 1), f"{name}: shape {Bn.shape}")
        check(bool(np.isfinite(Bn).all()), f"{name}: non-finite B")
        Bh = core.hard_threshold_final(B, d.lam).cpu().numpy()
        msg = (f"fit {name}: {secs:.3f} s wall, est.err "
               f"{core.metrics.estimation_error(Bn, d.beta_star):.4f}, F1 "
               f"{core.metrics.mean_f1(Bn, d.beta_star):.3f}, F1 after hard "
               f"threshold {core.metrics.mean_f1(Bh, d.beta_star):.3f}, "
               f"support {core.metrics.mean_support_size(Bh):.1f}")
        if ref is not None:
            dev = float(np.max(np.abs(Bn - ref)))
            msg += f", max|dev| vs plain {dev:.3e} (tol {tol:g})"
            check(dev <= tol, f"{name}: max|dev| {dev:.3e} > {tol}")
        log(msg)
        return Bn

    ops.reset_launches()
    counts = lambda: dict(ops.launches)

    ref, s = timed(lambda: core.decsvm_fit(X, y, W, cfg("jnp"), **on))
    ref = report("jnp (plain, reference)", ref, s)

    on_card = d.device.type == "cuda"
    instances = lambda: dict(ops.round_block_launches)

    c0, i0 = counts(), instances()
    B, s = timed(lambda: core.decsvm_fit(X, y, W, cfg("megakernel"), **on))
    report("megakernel", B, s, ref, FIT_TOL["float32"])
    check(ops.launches["csvm_round_block"] - c0["csvm_round_block"] == 1,
          "megakernel fit: expected one csvm_round_block launch")
    if on_card:
        ran = {k: v - i0[k] for k, v in instances().items()}
        check(ran == {"stream": 1, "direct": 0},
              f"megakernel fit: round kernel instances {ran}, expected one "
              "stream launch")

    c0 = counts()
    (B, H), s = timed(lambda: core.decsvm_fit(X, y, W, cfg("megakernel"),
                                              track_history=True, **on))
    report("megakernel track_history", B, s, ref, FIT_TOL["float32"])
    check(tuple(H.shape) == (max_iter, sim.m, sim.p + 1), "history shape")
    check(ops.launches["csvm_block_update"] - c0["csvm_block_update"]
          == max_iter, "track_history fit: expected one csvm_block_update "
          "launch per round")

    c0 = counts()
    B, s = timed(lambda: core.decsvm_fit(X, y, W, cfg("pallas"), **on))
    report("pallas", B, s, ref, FIT_TOL["float32"])
    check(ops.launches["csvm_local_update"] - c0["csvm_local_update"]
          == max_iter, "pallas fit: expected one csvm_local_update launch "
          "per round")

    tol_kw = dict(tol=kkt_tol, stop_rule="kkt", check_every=CHECK_EVERY)
    (Bt, tt), s = timed(lambda: core.decsvm_fit_tol(X, y, W, cfg("jnp"),
                                                    **tol_kw, **on))
    tt = int(tt)
    ref_tol = report(f"tol kkt {kkt_tol:g} jnp (plain, reference) t={tt}",
                     Bt, s)
    check(tt < max_iter, f"plain KKT fit: tol {kkt_tol:g} not reached in "
          f"{max_iter} rounds, so the stopping round is not compared")

    c0, i0 = counts(), instances()
    (B16, t16), s = timed(lambda: core.decsvm_fit_tol(
        X, y, W, cfg("megakernel_bf16"), **tol_kw, **on))
    t16 = int(t16)
    B16n = report(f"tol kkt {kkt_tol:g} megakernel_bf16 t={t16} (plain "
                  f"t={tt})", B16, s, ref_tol, FIT_TOL["bfloat16"])
    check(abs(t16 - tt) <= CHECK_EVERY,
          f"bf16 KKT fit stopped at t={t16}, the plain fit at t={tt}: more "
          f"than one check block ({CHECK_EVERY} rounds) apart")
    supp = np.abs(ref_tol) > FIT_TOL["bfloat16"]
    check(np.array_equal(np.sign(B16n)[supp], np.sign(ref_tol)[supp]),
          "bf16 tol fit: support signs differ from the fp32 fit")
    n_blocks = ops.launches["csvm_round_block"] - c0["csvm_round_block"]
    check(n_blocks == math.ceil(t16 / CHECK_EVERY),
          f"bf16 tol fit: {n_blocks} csvm_round_block launches for "
          f"t={t16} rounds in blocks of {CHECK_EVERY}")
    if on_card:
        ran = {k: v - i0[k] for k, v in instances().items()}
        check(ran == {"stream": n_blocks, "direct": 0},
              f"bf16 tol fit: round kernel instances {ran}, expected all "
              f"{n_blocks} on the stream instance")
    launches = {name: ops.launches[name] for name in FIT_KERNELS}
    for name in FIT_KERNELS:
        check(launches[name] >= 1, f"fit path never launched {name}")
    log(f"fit path launches: {json.dumps(launches)}; csvm_round_block by "
        f"instance: {json.dumps(instances())}")
    return launches


def synchronize(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def attention_inputs(torch, case, dtype, device, seed):
    """q (B, H, S, D), k and v (B, KV, S, D) from a seeded generator; the
    qwen3-14b cases are the model's (B, S, heads, D) buffers seen through
    ``.transpose(1, 2)``, as ``attention.self_attend`` feeds the kernel."""
    B, H, KV, S, D = case[:5]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    strided = H == 40

    def draw(heads):
        shape = (B, S, heads, D) if strided else (B, heads, S, D)
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).to(getattr(torch, dtype))
        return t.transpose(1, 2) if strided else t
    return draw(H), draw(KV), draw(KV)


def flash_deviation(torch, got, want, dtype):
    """(max |got - want|, the share of the limit it uses): fp32 against
    FLASH_TOL_F32, bf16 against one bf16 ulp of the plain output."""
    dev = (got.float() - want.float()).abs()
    if dtype == "float32":
        limit = torch.full_like(dev, FLASH_TOL_F32)
    else:
        limit = BF16_ULP * want.float().abs() + 1e-6
    return float(dev.max()), float((dev / limit).max())


def flash_checks(torch, ops, ref, device, devs: dict):
    """``flash_attention`` against ``ref.mha`` on the same inputs; on the
    card each case must launch the instance ``ops.flash_instance`` names."""
    for i, case in enumerate(FLASH_CASES):
        B, H, KV, S, D, causal, window = case
        for dtype in ("float32", "bfloat16"):
            q, k, v = attention_inputs(torch, case, dtype, device, seed=i)
            before = dict(ops.flash_launches)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            instance = "plain"
            if torch.device(device).type == "cuda":
                instance = ops.flash_instance(q.dtype, D)
                ran = {name: n - before[name]
                       for name, n in ops.flash_launches.items()}
                check(ran[instance] == 1 and sum(ran.values()) == 1,
                      f"flash_attention {case} {dtype}: launched {ran}, "
                      f"expected one {instance} launch")
            want = ref.mha(q, k, v, causal=causal, window=window)
            check(tuple(got.shape) == tuple(q.shape) and got.dtype == q.dtype,
                  f"flash_attention {case}: output {tuple(got.shape)} "
                  f"{got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"flash_attention {case} {dtype}: non-finite output")
            dev, share = flash_deviation(torch, got, want, dtype)
            record(devs, "flash_attention", dtype, dev)
            what = (f"flash_attention B={B} H={H} KV={KV} S={S} D={D} "
                    f"causal={causal} window={window} {dtype} [{instance}]")
            check(share <= 1.0, f"{what}: max|dev| {dev:.3e} is "
                  f"{share:.2f}x the limit")
            log(f"check {what}: max|dev| {dev:.3e} ({share:.3f} of the "
                "limit)")


def attention_bound(B, H, KV, S, D, itemsize):
    """Causal attention: 4*B*H*D*S(S+1)/2 flops against the bf16 tensor
    peak, or q, k, v read and o written once against the memory rate."""
    flops = 4 * B * H * D * S * (S + 1) / 2
    nbytes = (2 * B * H + 2 * B * KV) * S * D * itemsize
    return bound(flops, nbytes, PEAK_BF16)


def flash_timings(torch, ops, ref, device):
    """The kernel beside its plain version (in turns), its bound and
    ``scaled_dot_product_attention`` on the same bf16 inputs, at
    qwen3-14b's shapes; the first row is S = 2048.  The tensor-core
    instance runs, as on the main path; the fp32-FMA instance, the earlier
    design, is timed on the same bf16 inputs as ``fma_ms`` (and, on fp32
    inputs of the same shapes, its own use, as ``fma_fp32_ms``)."""
    F = torch.nn.functional
    rows = []
    for S in (2048, 1023):
        case = (1, 40, 8, S, 128, True, None)
        q, k, v = attention_inputs(torch, case, "bfloat16", device, seed=S)
        check(ops.flash_instance(q.dtype, 128) == "wgmma",
              "qwen3-14b's attention does not take the tensor-core instance")
        times = paired_ms(
            torch, lambda: ops.flash_attention(q, k, v, causal=True),
            lambda: ref.mha(q, k, v, causal=True), 20, 3)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
        fma = cuda_ms(torch, lambda: ops._flash_launch(
            q, k, v, "fma", causal=True, window=None, sm_scale=None), 5)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        fma32 = cuda_ms(torch, lambda: ops.flash_attention(
            q32, k32, v32, causal=True), 3)
        bms, by = attention_bound(1, 40, 8, S, 128, 2)
        flops = 4 * 40 * 128 * S * (S + 1) / 2
        rows.append(dict(times, bound_ms=bms, bound_by=by, library_ms=lib,
                         fma_ms=fma, fma_fp32_ms=fma32,
                         tflops=flops / times["ms"] / 1e9,
                         shape=f"q (1, 40, {S}, 128), kv (1, 8, {S}, 128) "
                               "bf16, causal"))
    for v in rows:
        log(f"time flash_attention [{v['shape']}]: {v['ms']:.4f} ms "
            f"(samples {v['ms_samples'][0]:.4f}, {v['ms_samples'][1]:.4f}; "
            f"{v['tflops']:.1f} TFLOP/s, {v['bound_ms'] / v['ms']:.3f} of the "
            f"bound), plain {v['plain_ms']:.4f} ms, bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']}), "
            f"scaled_dot_product_attention {v['library_ms']:.4f} ms; fp32-FMA "
            f"instance {v['fma_ms']:.4f} ms on the same bf16 inputs, "
            f"{v['fma_fp32_ms']:.4f} ms on fp32")
    return dict(rows[0], variants=rows[1:])


def serving_path(torch, ops, engine, cfg, params, *, prompts=SERVE_PROMPTS,
                 max_new=SERVE_NEW, max_batch=SERVE_BATCH,
                 max_len=SERVE_LEN, seed=0, kernel="flash_attention"):
    """Serve len(prompts) requests through ``ServeEngine`` with block
    prefill, with the launch counters set to 0 just before the run and
    read just after; every request must finish with ``max_new`` tokens of
    the padded vocabulary, every prefill must launch ``kernel`` once per
    layer, and no other kernel may launch.  Returns the launches and the
    prefill / decode times."""
    import numpy as np
    device = params.device
    eng = engine.ServeEngine(cfg, params, max_batch=max_batch,
                             max_len=max_len, block_prefill=True,
                             device=device)
    prefills, decodes = [], []

    def timed(fn, out, label):
        def run(*args):
            synchronize(torch, device)
            t0 = time.perf_counter()
            result = fn(*args)
            synchronize(torch, device)
            out.append((label(*args), 1e3 * (time.perf_counter() - t0)))
            return result
        return run

    eng._prefill_slot = timed(eng._prefill_slot, prefills,
                              lambda b, req: len(req.prompt) - 1)
    eng._decode = timed(eng._decode, decodes,
                        lambda toks, pos: sum(s is not None
                                              for s in eng.slots))
    rng = np.random.default_rng(seed)
    for rid, n in enumerate(prompts):
        eng.submit(engine.Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, n).tolist(), max_new=max_new))
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    synchronize(torch, device)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    instances = dict(ops.flash_launches)
    check(sorted(done) == list(range(len(prompts))),
          f"serving: completed {sorted(done)} of {len(prompts)} requests")
    for rid, req in sorted(done.items()):
        check(len(req.generated) == max_new and all(
            0 <= t < cfg.padded_vocab for t in req.generated),
            f"serving: request {rid} generated {req.generated}")
    want = cfg.num_layers * len(prompts)
    check(launches[kernel] == want,
          f"serving: {launches[kernel]} {kernel} launches, expected {want} "
          f"({cfg.num_layers} per prefilled request)")
    check(len(prefills) == len(prompts), "serving: a prompt skipped prefill")
    for name, count in launches.items():
        check(name == kernel or count == 0, f"serving launched {name}")
    for S, ms in prefills:
        log(f"serve prefill S={S}: {ms:.2f} ms")
    steps = [ms for _, ms in decodes]
    log(f"serve: {len(done)} requests x {max_new} tokens in {wall:.2f} s, "
        f"{len(decodes)} decode steps, median {float(np.median(steps)):.2f}"
        f" ms (min {min(steps):.2f}, max {max(steps):.2f}); launches "
        f"{json.dumps(launches)}; first tokens "
        f"{[done[r].generated[:4] for r in sorted(done)]}")
    return dict(launches=launches, flash_instances=instances,
                prefill_ms=prefills, decode_ms=decodes, wall_s=wall)


def plain_self_attend(q, k, v, *, causal, window):
    """The plain attention on any device (the check's yardstick only)."""
    import torch
    from repro_torch.models import attention
    pos = torch.arange(q.shape[1], device=q.device)
    return attention._attend(q, k, v, pos, pos, causal=causal,
                             window=window)


def kernel_vs_plain_in_model(torch, ops, cfg, params, *, label, tol,
                             prompt=MODEL_PROMPT, seed=1):
    """Block-prefill logits of one prompt with the kernel and with the
    plain attention swapped in; returns (max |dev|, max |logit|)."""
    import numpy as np
    from repro_torch.models import attention
    from repro_torch.models.prefill import prefill
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (1, prompt))
    batch = {"tokens": toks}
    before = ops.launches["flash_attention"]
    kern, _, _ = prefill(params, batch, cfg, prompt + 1)
    check(ops.launches["flash_attention"] - before == cfg.num_layers,
          f"{label}: the prefill did not launch the kernel once per layer")
    kernel_attend = attention.self_attend
    attention.self_attend = plain_self_attend
    try:
        plain, _, _ = prefill(params, batch, cfg, prompt + 1)
    finally:
        attention.self_attend = kernel_attend
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
    dev = float((kern.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    log(f"model {label}: prefill logits {tuple(kern.shape)}, kernel vs plain "
        f"attention max|dev| {dev:.4e} (limit {tol:g}), max|logit| "
        f"{scale:.4f}")
    check(dev <= tol, f"{label}: max|dev| {dev:.4e} > {tol}")
    return dev, scale


def ssd_inputs(torch, case, dtype, device, seed):
    """x (b, s, h, p), dt (b, s, h), A, D (h,), B and C (b, s, n).  The
    tests/test_kernels.py cases draw them as that file does (standard
    normal x, B, C; dt = |N| 0.1 + 0.01; A = -(|N| + 0.5); D = |N|).
    mamba2-370m's cases draw them as the model forms them: x, B and C are
    column slices of one (b, s, h·p + 2n) conv output, silu(0.5 N); dt =
    softplus(N); A = -linspace(1, 16, h) and D = 1, as ``init_mamba``."""
    b, s, h, p, n = case[:5]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    wide = getattr(torch, dtype)
    if (h, p, n) == (32, 64, 128):
        buf = torch.nn.functional.silu(
            0.5 * torch.randn((b, s, h * p + 2 * n), **f32)).to(wide)
        x = buf[..., :h * p].reshape(b, s, h, p)
        B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:]
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), **f32))
        A = -torch.linspace(1.0, 16.0, h, device=device)
        D = torch.ones(h, device=device)
        return x, dt, A, B, C, D
    x = torch.randn((b, s, h, p), **f32).to(wide)
    B = torch.randn((b, s, n), **f32).to(wide)
    C = torch.randn((b, s, n), **f32).to(wide)
    dt = torch.randn((b, s, h), **f32).abs() * 0.1 + 0.01
    A = -(torch.randn((h,), **f32).abs() + 0.5)
    D = torch.randn((h,), **f32).abs()
    return x, dt, A, B, C, D


def ssd_deviation(torch, got, want, dtype):
    """((y max |dev|, share of its limit), (state max |dev|, share)): y
    against SSD_TOL_F32 (fp32) or one bf16 ulp of the plain y (bf16); the
    state against SSD_TOL_F32 (1 + |s_plain|)."""
    dy = (got[0].float() - want[0].float()).abs()
    if dtype == "float32":
        limit = torch.full_like(dy, SSD_TOL_F32)
    else:
        limit = BF16_ULP * want[0].float().abs() + 1e-6
    ds = (got[1] - want[1]).abs()
    slimit = SSD_TOL_F32 * (1.0 + want[1].abs())
    return ((float(dy.max()), float((dy / limit).max())),
            (float(ds.max()), float((ds / slimit).max())))


def ssd_checks(torch, ops, ref, device, devs: dict):
    """``ssd_scan`` against ``ref.ssd_scan`` on the same inputs: y and the
    final state."""
    for i, case in enumerate(SSD_CASES):
        b, s, h, p, n, chunk = case
        for dtype in ("float32", "bfloat16"):
            args = ssd_inputs(torch, case, dtype, device, seed=i)
            got = ops.ssd_scan(*args, chunk=chunk)
            want = ref.ssd_scan(*args, chunk=chunk)
            what = f"ssd_scan b={b} s={s} h={h} p={p} n={n} chunk={chunk} {dtype}"
            check(tuple(got[0].shape) == (b, s, h, p)
                  and got[0].dtype == args[0].dtype
                  and tuple(got[1].shape) == (b, h, p, n)
                  and got[1].dtype == torch.float32,
                  f"{what}: outputs {tuple(got[0].shape)} {got[0].dtype}, "
                  f"{tuple(got[1].shape)} {got[1].dtype}")
            check(bool(torch.isfinite(got[0]).all()
                       and torch.isfinite(got[1]).all()),
                  f"{what}: non-finite output")
            (dy, sy), (dst, sst) = ssd_deviation(torch, got, want, dtype)
            record(devs, "ssd_scan", dtype, max(dy, dst))
            check(sy <= 1.0, f"{what}: y max|dev| {dy:.3e} is {sy:.2f}x the "
                  "limit")
            check(sst <= 1.0, f"{what}: state max|dev| {dst:.3e} is "
                  f"{sst:.2f}x the limit")
            log(f"check {what}: y max|dev| {dy:.3e} ({sy:.3f} of the limit),"
                f" state max|dev| {dst:.3e} ({sst:.3f} of the limit)")


def ssd_bound(b, s, h, p, n, chunk, itemsize):
    """One scan: 2·b·h·s·(Q·n + Q·p + 2·p·n) flops (C B^T and its product
    with x·dt over full Q x Q tiles, the carry-in and the state update)
    against the peak of the input type, or x read and y written (itemsize),
    B and C read (itemsize), dt read and the final state written (fp32)
    against the memory rate."""
    flops = 2 * b * h * s * (chunk * n + chunk * p + 2 * p * n)
    nbytes = ((2 * b * s * h * p + 2 * b * s * n) * itemsize
              + b * s * h * 4 + 2 * h * 4 + b * h * p * n * 4)
    return bound(flops, nbytes, PEAK_BF16 if itemsize == 2 else PEAK_FP32)


def ssd_timings(torch, ops, ref, device):
    """The kernel beside its plain version (in turns) and its bound at
    mamba2-370m's bf16 shapes; the first row is S = 2048.  No single torch
    call computes the scan, so there is no library time."""
    rows = []
    for S in (2048, 1023):
        case = (1, S, 32, 64, 128, 64)
        args = ssd_inputs(torch, case, "bfloat16", device, seed=S)
        times = paired_ms(torch, lambda: ops.ssd_scan(*args, chunk=64),
                          lambda: ref.ssd_scan(*args, chunk=64), 20, 3)
        bms, by = ssd_bound(*case, 2)
        rows.append(dict(times, bound_ms=bms, bound_by=by, library_ms=None,
                         shape=f"x (1, {S}, 32, 64), B/C (1, {S}, 128) "
                               "bf16 strided, chunk 64"))
    for v in rows:
        log(f"time ssd_scan [{v['shape']}]: {v['ms']:.4f} ms (samples "
            f"{v['ms_samples'][0]:.4f}, {v['ms_samples'][1]:.4f}), plain "
            f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']}), library: none")
    return dict(rows[0], variants=rows[1:])


def plain_ssd(x, dt, A, B, C, D, cfg):
    """The plain scan on any device, at the kernel's chunk (the check's
    yardstick only)."""
    from repro_torch.kernels import ref
    return ref.ssd_scan(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)


def ssd_vs_plain_in_model(torch, ops, cfg, params, *, label, tol,
                          prompt=MAMBA_PROMPT, seed=1):
    """Block-prefill logits and seeded SSM states of one prompt with the
    kernel and with the plain scan swapped in; returns (logits max |dev|,
    max |logit|, state max |dev|)."""
    import numpy as np
    from repro_torch.models import ssm
    from repro_torch.models.prefill import prefill
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (1, prompt))
    batch = {"tokens": toks}
    before = ops.launches["ssd_scan"]
    kern, kcache, _ = prefill(params, batch, cfg, prompt + 1)
    check(ops.launches["ssd_scan"] - before == cfg.num_layers,
          f"{label}: the prefill did not launch the kernel once per layer")
    kernel_ssd = ssm.ssd
    ssm.ssd = plain_ssd
    try:
        plain, pcache, _ = prefill(params, batch, cfg, prompt + 1)
    finally:
        ssm.ssd = kernel_ssd
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
    check(bool(torch.isfinite(kcache["layers"]["ssm"]).all()),
          f"{label}: non-finite SSM state")
    dev = float((kern.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    sdev = float((kcache["layers"]["ssm"] - pcache["layers"]["ssm"])
                 .abs().max())
    smax = float(pcache["layers"]["ssm"].abs().max())
    log(f"model {label}: prefill logits {tuple(kern.shape)}, kernel vs plain "
        f"scan max|dev| {dev:.4e} (limit {tol:g}), max|logit| {scale:.4f}; "
        f"seeded SSM state {tuple(kcache['layers']['ssm'].shape)} max|dev| "
        f"{sdev:.4e} (limit {tol:g}), max|state| {smax:.4f}")
    check(dev <= tol, f"{label}: logits max|dev| {dev:.4e} > {tol}")
    check(sdev <= tol, f"{label}: state max|dev| {sdev:.4e} > {tol}")
    return dev, scale, sdev


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are not under {ROOT / 'src'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import repro_torch.core as core
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import csvm_update as cu
    from repro_torch.models import model
    from repro_torch.serving import engine

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s (one nvcc per source, "
        f"in parallel), {sorted(p.name for p in libs.values())}")
    for name in libs:
        smem = ptxas_smem(build.build_log(name))
        for kernel, regs, spills in ptxas_report(build.build_log(name)):
            extra = ""
            if kernel.startswith("round_stream_kernel"):
                isz = 4 if "float" in kernel else 2
                extra = (f", {smem[kernel]} bytes static shared memory + "
                         f"{ops.round_stream_smem_bytes(4096, isz)} dynamic "
                         "at p = 4096")
            log(f"ptxas {kernel}: {regs} registers, {spills}{extra}")
    sass = tensor_core_sass(build)
    bulk = bulk_copy_sass(build)
    for bf16 in (False, True):
        per_sm, sms = ops.round_block_occupancy(0, bf16)
        st_sm, _ = ops.round_block_occupancy(0, bf16, "stream", 4096)
        grid = ops.round_block_grid(
            0, 16, 1024, 4096, torch.bfloat16 if bf16 else torch.float32)
        log(f"round kernel ({'bf16' if bf16 else 'fp32'} X): direct {per_sm} "
            f"co-resident blocks per SM x {sms} SMs; stream {st_sm} per SM at"
            f" p = 4096, grid {grid} at X (16, 1024, 4096)")

    # phases 3-4: the CSVM kernels and the fit path
    devs = {}
    t0 = time.perf_counter()
    design = Data(torch, core, core.SimConfig(p=100, s=10, m=10, n=200))
    full = Data(torch, core, core.SimConfig(p=4095, s=10, m=16, n=1024,
                                            rho=0.5))
    log(f"data: {time.perf_counter() - t0:.1f} s; full X "
        f"{tuple(full.X.shape)} lam {full.lam:.5f} h {full.h:.5f}")
    kernel_checks(torch, ops, cu, design, "design (10, 200, 101)", devs)
    kernel_checks(torch, ops, cu, full, "full (16, 1024, 4096)", devs)
    torch.cuda.synchronize()
    rows = kernel_timings(torch, ops, cu, full, 300)
    launches = main_path(torch, core, ops, full)
    round_instances = dict(ops.round_block_launches)
    del design, full

    # phase 5: flash_attention against its plain version, and its times
    flash_checks(torch, ops, ref, "cuda", devs)
    torch.cuda.synchronize()
    rows["flash_attention"] = flash_timings(torch, ops, ref, "cuda")

    # phase 6: the serving path at full width
    cfg = configs.get("qwen3_14b")
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    log(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.padded_vocab} (padded), "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
        f"parameters, {weight_bytes / 1e9:.2f} GB {cfg.param_dtype}, drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    served = serving_path(torch, ops, engine, cfg, params)
    launches["flash_attention"] = served["launches"]["flash_attention"]
    check(served["flash_instances"] == {
        "wgmma": launches["flash_attention"], "fma": 0},
        f"serving: flash launches by instance {served['flash_instances']}, "
        "expected every one on the tensor-core instance")
    cache_bytes = (2 * cfg.num_layers * SERVE_BATCH * SERVE_LEN
                   * cfg.num_kv_heads * cfg.head_dim * 2)
    steps = [ms for _, ms in served["decode_ms"]]
    decode_bound = 1e3 * weight_bytes / PEAK_BYTES
    log(f"serve decode: median {float(np.median(steps)):.2f} ms a step "
        f"against the weight-read bound {decode_bound:.2f} ms "
        f"({weight_bytes / 1e9:.2f} GB / 3.35 TB/s); the KV cache is "
        f"{cache_bytes / 1e9:.3f} GB")

    # phase 7: the kernel against the plain attention inside the model
    model_devs = {"bfloat16": kernel_vs_plain_in_model(
        torch, ops, cfg, params, label=f"{cfg.name} bf16 40 layers",
        tol=MODEL_TOL["bfloat16"])}
    del params
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32")
    params = model.init_params(cfg2, seed=0, device="cuda")
    model_devs["float32"] = kernel_vs_plain_in_model(
        torch, ops, cfg2, params, label=f"{cfg.name} fp32 2 layers",
        tol=MODEL_TOL["float32"])
    del params
    torch.cuda.empty_cache()
    # the reduced config (D = 64, group 2) in bf16: the tensor-core
    # instance at its other head dim, inside the model
    cfg3 = configs.get_reduced("qwen3_14b", param_dtype="bfloat16")
    params = model.init_params(cfg3, seed=0, device="cuda")
    before = ops.flash_launches["wgmma"]
    model_devs["bfloat16 reduced"] = kernel_vs_plain_in_model(
        torch, ops, cfg3, params, label=f"{cfg3.name} bf16 D = "
        f"{cfg3.head_dim}", tol=MODEL_TOL["bfloat16"])
    check(ops.flash_launches["wgmma"] - before == cfg3.num_layers,
          f"{cfg3.name}: the prefill did not take the tensor-core instance")
    del params
    torch.cuda.empty_cache()

    # phase 8: ssd_scan against its plain version, and its times
    ssd_checks(torch, ops, ref, "cuda", devs)
    torch.cuda.synchronize()
    rows["ssd_scan"] = ssd_timings(torch, ops, ref, "cuda")

    # phase 9: the mamba2 serving path at full width
    mcfg = configs.get("mamba2_370m")
    t0 = time.perf_counter()
    params = model.init_params(mcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    m_weight_bytes = sum(p.numel() * p.element_size()
                         for p in params.parameters())
    log(f"model {mcfg.name}: {mcfg.num_layers} layers, d_model "
        f"{mcfg.d_model}, d_inner {mcfg.ssm_dinner}, {mcfg.ssm_nheads} heads "
        f"x {mcfg.ssm_headdim}, state {mcfg.ssm_state}, chunk "
        f"{mcfg.ssm_chunk}, vocab {mcfg.padded_vocab} (padded, tied), "
        f"{sum(p.numel() for p in params.parameters()) / 1e6:.1f} M "
        f"parameters, {m_weight_bytes / 1e9:.3f} GB {mcfg.param_dtype}, "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    m_served = serving_path(torch, ops, engine, mcfg, params,
                            kernel="ssd_scan")
    launches["ssd_scan"] = m_served["launches"]["ssd_scan"]
    m_steps = [ms for _, ms in m_served["decode_ms"]]
    conv_ch = mcfg.ssm_dinner + 2 * mcfg.ssm_groups * mcfg.ssm_state
    m_state_bytes = mcfg.num_layers * SERVE_BATCH * (
        mcfg.ssm_nheads * mcfg.ssm_headdim * mcfg.ssm_state * 4
        + (mcfg.conv_width - 1) * conv_ch * 2)
    m_decode_bound = 1e3 * (m_weight_bytes + 2 * m_state_bytes) / PEAK_BYTES
    log(f"serve decode {mcfg.name}: median {float(np.median(m_steps)):.2f} "
        f"ms a step against the bound {m_decode_bound:.3f} ms (the weights "
        f"read once, {m_weight_bytes / 1e9:.3f} GB, and the "
        f"{m_state_bytes / 1e9:.3f} GB conv and SSM state read and written "
        "once, at 3.35 TB/s)")

    # phase 10: the kernel against the plain scan inside the model
    mamba_devs = {"bfloat16": ssd_vs_plain_in_model(
        torch, ops, mcfg, params, label=f"{mcfg.name} bf16 48 layers",
        tol=MAMBA_TOL["bfloat16"])}
    del params
    torch.cuda.empty_cache()
    mcfg2 = dataclasses.replace(mcfg, num_layers=2, param_dtype="float32")
    params = model.init_params(mcfg2, seed=0, device="cuda")
    mamba_devs["float32"] = ssd_vs_plain_in_model(
        torch, ops, mcfg2, params, label=f"{mcfg.name} fp32 2 layers",
        tol=MAMBA_TOL["float32"])
    del params

    flash_tol = {"float32": FLASH_TOL_F32,
                 "bfloat16": "2^-7 |o_plain| + 1e-6 (one bf16 ulp)"}
    ssd_tol = {"float32": f"y {SSD_TOL_F32:g}",
               "bfloat16": "y 2^-7 |y_plain| + 1e-6 (one bf16 ulp)",
               "state": f"{SSD_TOL_F32:g} (1 + |s_plain|)"}
    kernels = []
    for name in ops.KERNELS:
        dev = max(devs[name].values())
        row = dict(rows[name])
        extra = {}
        if name == "flash_attention":
            tol = flash_tol
            extra = dict(serve=dict(
                prefill_ms=served["prefill_ms"],
                decode_ms_median=float(np.median(steps)),
                decode_bound_ms=decode_bound, wall_s=served["wall_s"]),
                model_kernel_vs_plain={
                    dt: dict(max_abs_dev=d, max_abs_logit=m,
                             tol=MODEL_TOL[dt.split()[0]])
                    for dt, (d, m) in model_devs.items()},
                serve_instances=served["flash_instances"],
                sass={f"flash_tc_kernel<{D}>": dict(HGMMA=h, UTMALDG=u)
                      for D, (h, u) in sass.items()})
        elif name == "ssd_scan":
            tol = ssd_tol
            extra = dict(serve=dict(
                prefill_ms=m_served["prefill_ms"],
                decode_ms_median=float(np.median(m_steps)),
                decode_bound_ms=m_decode_bound, wall_s=m_served["wall_s"]),
                model_kernel_vs_plain={
                    dt: dict(max_abs_dev=d, max_abs_logit=m,
                             max_abs_state_dev=sd, tol=MAMBA_TOL[dt])
                    for dt, (d, m, sd) in mamba_devs.items()})
        else:
            tol = {dt: TOL[dt] for dt in devs[name]}
            row["library_ms"] = None
            if name == "csvm_round_block":
                extra = dict(
                    instance_launches=round_instances,
                    sass={f"round_stream_kernel<{dt}>": dict(UBLKCP=b,
                                                             UTMALDG=u)
                          for dt, (b, u) in bulk.items()})
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=dev, max_abs_dev=dev,
            max_abs_dev_by_dtype=devs[name], tol=tol, **row, **extra))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
