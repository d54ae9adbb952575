#!/usr/bin/env python3
"""GPU smoke run of the torch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases (each prints its lines; any failure exits non-zero before the
result lines):

1. the card: ``nvidia-smi`` name and power limit, TF32 switched off;
2. the build: ``nvcc`` compiles the CUDA sources of the port;
3. the kernels: each CUDA kernel against its plain torch version on the
   card, at the paper's design size and at the full size below, in fp32
   and bf16, with held rounds, ``nact = 0``, lambda vectors and
   ``lam0 > 0``; then their times (CUDA events) beside the plain
   versions' and the bound;
4. the main path at full size — ``SimConfig(p=4095, s=10, m=16, n=1024,
   rho=0.5)`` on ``erdos_renyi(16, 0.5, seed=0)``, X (16, 1024, 4096):
   ``decsvm_fit`` under ``megakernel`` (with and without
   ``track_history``) and ``pallas``, ``decsvm_fit_tol`` (KKT stop) under
   ``megakernel_bf16``, each against the plain ``jnp`` backend on the
   card, with the launch counters read around the fits; the KKT fits
   must stop before ``max_iter`` and within one check block of each
   other.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

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

REPLACES = {
    "csvm_local_update": "src/repro/kernels/csvm_update.py:83",
    "csvm_block_update": "src/repro/kernels/csvm_update.py:349",
    "csvm_round_block": "src/repro/kernels/csvm_update.py:277",
}
SOURCE = "src/repro_torch/kernels/csrc/csvm_update.cu"


def log(*args):
    print(*args, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def ptxas_report(log_text: str):
    """(kernel<type>, registers, spills) per entry function of nvcc's
    ``-Xptxas -v`` output."""
    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '.*?\d+([a-z_]+_kernel)I"
                          r"(f|13__nv_bfloat16)E", line)
        if entry:
            dtype = "float" if entry.group(2) == "f" else "bf16"
            name = f"{entry.group(1)}<{dtype}>"
        elif "spill" in line:
            spills = line.strip()
        else:
            regs = re.search(r"Used (\d+) registers", line)
            if regs and name:
                out.append((name, int(regs.group(1)), spills))
                name = None
    return out


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
    for dtype, R, nact, kkt, lam0, vec in cases:
        omega = d.omega0 if lam0 else d.omega
        args = (d.x(dtype), d.y, d.B, d.P, d.W, d.deg, d.rho, omega,
                d.lam_vec if vec else d.lam_flat)
        kw = dict(tau=1.0, lam0=lam0, h=d.h, num_rounds=R, want_kkt=kkt)
        got = ops.csvm_round_block(*args, nact_t(nact), **kw)
        want = cu.csvm_round_block_plain(*args, nact, **kw)
        what = (f"csvm_round_block {label} {dtype} rounds={R} nact={nact} "
                f"kkt={kkt} lam0={lam0} lam_vector={vec}")
        dev = compare(torch, got, want, dtype, what)
        if nact == 0:
            check(torch.equal(got[0], d.B) and torch.equal(got[1], d.P),
                  f"{what}: held rounds changed B or P")
        record(devs, "csvm_round_block", dtype, dev)
        log(f"check {what}: max|dev| {dev:.3e} stat {float(got[2]):.6g} "
            f"(plain {float(want[2]):.6g})")


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
    for dtype, R, kkt in (("float32", max_iter, False),
                          ("bfloat16", 4, True)):
        args = (d.x(dtype), d.y, d.B, d.P, d.W, d.deg, d.rho, d.omega,
                d.lam_flat)
        kw = dict(tau=1.0, lam0=0.0, h=d.h, num_rounds=R, want_kkt=kkt)
        nact = torch.tensor(R, dtype=torch.int32, device=d.device)
        reps = 3 if R > 10 else 20
        times = paired_ms(
            torch, lambda: ops.csvm_round_block(*args, nact, **kw),
            lambda: cu.csvm_round_block_plain(*args, R, **kw), reps,
            max(1, reps // 3))
        isz = 4 if dtype == "float32" else 2
        nbytes = (ops.round_block_bytes(m, n, p, isz, R)
                  - 4 * ops.round_block_scratch_floats(m, n, p, R))
        # the margins and X^T w of each round, and once more at beta_bar
        # for the KKT epilogue; the W@B sums (2 m^2 p a round) are left out
        flops = 4 * m * n * p * (R + (1 if kkt else 0))
        bms, by = bound(flops, nbytes,
                        PEAK_FP32 if dtype == "float32" else PEAK_BF16)
        variants.append(dict(times, bound_ms=bms, bound_by=by,
                             shape=f"X ({m}, {n}, {p}) {dtype}, {R} rounds, "
                                   f"want_kkt={kkt}"))
    rows["csvm_round_block"] = dict(variants[0], variants=variants[1:])
    for name, row in rows.items():
        for v in [row] + row.get("variants", []):
            log(f"time {name} [{v['shape']}]: {v['ms']:.4f} ms "
                f"(samples {v['ms_samples'][0]:.4f}, "
                f"{v['ms_samples'][1]:.4f}), plain {v['plain_ms']:.4f} ms "
                f"(samples {v['plain_ms_samples'][0]:.4f}, "
                f"{v['plain_ms_samples'][1]:.4f}), bound "
                f"{v['bound_ms']:.4f} ms ({v['bound_by']})")
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

    def synchronize():
        if d.device.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        synchronize()
        t0 = time.perf_counter()
        out = fn()
        synchronize()
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

    c0 = counts()
    B, s = timed(lambda: core.decsvm_fit(X, y, W, cfg("megakernel"), **on))
    report("megakernel", B, s, ref, FIT_TOL["float32"])
    check(ops.launches["csvm_round_block"] - c0["csvm_round_block"] == 1,
          "megakernel fit: expected one csvm_round_block launch")

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

    c0 = counts()
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
    launches = counts()
    for name in ops.KERNELS:
        check(launches[name] >= 1, f"main path never launched {name}")
    log(f"main path launches: {json.dumps(launches)}")
    return launches


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
    import repro_torch.core as core
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import csvm_update as cu

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
    lib = build.build("csvm_update")
    log(f"build: {time.perf_counter() - t0:.1f} s, {lib.name}")
    for kernel, regs, spills in ptxas_report(build.build_log("csvm_update")):
        log(f"ptxas {kernel}: {regs} registers, {spills}")
    for bf16 in (False, True):
        per_sm, sms = ops.round_block_occupancy(0, bf16)
        log(f"round kernel ({'bf16' if bf16 else 'fp32'} X): {per_sm} "
            f"co-resident blocks per SM x {sms} SMs")

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

    kernels = []
    for name in ops.KERNELS:
        dev = max(devs[name].values())
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=dev, max_abs_dev=dev,
            max_abs_dev_by_dtype=devs[name],
            tol={dt: TOL[dt] for dt in devs[name]},
            library_ms=None, **rows[name]))
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
