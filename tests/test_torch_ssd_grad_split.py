"""Torch port, the tensor-core instance of ``ssd_scan_backward`` on the CPU:
its instance rule and the refusals of a forced ``"wgmma"`` before any
launch, and a plain emulation of its arithmetic — every product of
``csrc/ssd_backward.cu``'s ``"wgmma"`` kernels with its fp32 operand cut
into bf16 terms (the scaled B and C of the chunk pass, S, S^T, M^T,
state_in and g) and the bf16 x, dy, B, C taken exactly, fp32 sums — held
against ``jax.vjp`` of the JAX package's ``repro.models.ssm.ssd_chunked``
at phase 17's limits (``chip_smoke.SSD_BACKWARD_TOL`` for the fp32
gradients, one bf16 ulp plus that floor for dx, dB, dC), on both input
distributions of ``tests/test_torch_ssd_split.py``, a ragged tail and an
exp(cum) that underflows.  Three terms hold; two do not, which records
why the kernel pays for three.  The CUDA kernels themselves run only on
a card: ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm
from test_torch_ssd_split import _inputs, _product, _terms
from _torch_cases import one_thread  # noqa: F401

# the products whose fp32 operand the kernel cuts into bf16 terms
PRODUCTS = ("chunk_B", "chunk_C", "S", "ST", "MT", "g", "state_in")


def emulate_backward_tc(x, dt, A, B, C, D, dy, dfinal=None, *, chunk=64,
                        terms=None):
    """The arithmetic of the ``"wgmma"`` instance of ``ssd_scan_backward``
    in plain torch, ``terms[name]`` bf16 terms (default 3) for the fp32
    operand of each product of ``PRODUCTS``:
      (a) local (n, p) = (B dt exp(last - cum))^T x [chunk_B] and back =
          (C exp(cum))^T dy [chunk_C] per chunk;
      (b) state_in and g walked over the chunks (dfinal (b, h, p, n));
      (c) G = C B^T; S = (dy x^T) dt_j L; dC = S B [S] + exp(cum_i) dy
          state_in [state_in]; dB = S^T C [ST] + exp(last - cum_j) dt_j
          x^T g [g]; dxdt = M^T dy [MT] + exp(last - cum_j) B g^T [g], M =
          G L; dx = D dy + dt dxdt; dcum from R = S G, the carry-in's
          share, u; da, ddt, dA, dD.
    Returns (dx, ddt, dA, dB, dC, dD) as the kernel does: dx, dB, dC in
    x's dtype, the rest fp32."""
    k = {name: 3 for name in PRODUCTS}
    k.update(terms or {})
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    Q = chunk
    nc = -(-s // Q)
    pad = nc * Q - s
    xf, dtf, dyf = x.to(f32), dt.to(f32), dy.to(f32)
    Bf, Cf = B.to(f32), C.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dyf = F.pad(dyf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xc = xf.reshape(b, nc, Q, h, p)
    dyc = dyf.reshape(b, nc, Q, h, p)
    dtc = dtf.reshape(b, nc, Q, h)
    Bc, Cc = Bf.reshape(b, nc, Q, n), Cf.reshape(b, nc, Q, n)
    Af = A.to(f32)
    cum = ref._sequential_cumsum(dtc * Af, dim=2)            # (b, c, Q, h)
    last = cum[:, :, -1]
    ecum = torch.exp(cum)
    dec = torch.exp(last[:, :, None] - cum)
    # (a) the chunk pass
    bdec = Bc[..., None] * (dtc * dec)[:, :, :, None, :]     # (b, c, j, n, h)
    local = _product(_terms(bdec, k["chunk_B"]), xc, "bcjnh,bcjhp->bchnp")
    cexp = Cc[..., None] * ecum[:, :, :, None, :]            # (b, c, i, n, h)
    back = _product(_terms(cexp, k["chunk_C"]), dyc, "bcinh,bcihp->bchnp")
    # (b) the state walk, (n, p) states
    state = torch.zeros((b, h, n, p), dtype=f32)
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + local[:, c]
    grad = (torch.zeros((b, h, n, p), dtype=f32) if dfinal is None
            else dfinal.to(f32).transpose(-1, -2))
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = grad
        grad = grad * torch.exp(last[:, c])[..., None, None] + back[:, c]
    state_in = torch.stack(state_in, 1)                      # (b, c, h, n, p)
    gs = torch.stack(gs, 1)
    # (c) the gradient pass
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri[:, :, None], torch.exp(
        cum[:, :, :, None, :] - cum[:, :, None, :, :]), 0.0)  # (b, c, i, j, h)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None]
    S = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc) * dtc[:, :, None] * L
    R = S * G
    rrow, rcol = R.sum(dim=3), R.sum(dim=2)                  # (b, c, Q, h)
    off = _product(_terms(state_in, k["state_in"]), dyc,
                   "bchnp,bcihp->bcinh") * ecum[:, :, :, None, :]
    dC = (_product(_terms(S, k["S"]), Bc, "bcijh,bcjn->bcinh") + off).sum(-1)
    cpart = (Cc[..., None] * off).sum(dim=3)                  # (b, c, i, h)
    xg = _product(_terms(gs, k["g"]), xc, "bchnp,bcjhp->bcjnh")
    dB = (_product(_terms(S, k["ST"]), Cc, "bcijh,bcin->bcjnh")
          + (dec * dtc)[:, :, :, None, :] * xg).sum(-1)
    M = G * L
    gb = _product(_terms(gs, k["g"]), Bc, "bchnp,bcjn->bcjhp")
    stt = dec[..., None] * gb
    dxdt = _product(_terms(M, k["MT"]), dyc, "bcijh,bcihp->bcjhp") + stt
    dx = D.to(f32)[:, None] * dyc + dtc[..., None] * dxdt
    u = ((xc * dtc[..., None]) * stt).sum(-1)
    xd = (xc * dxdt).sum(-1)
    dcum = rrow - rcol + cpart - u
    gdot = (gs * state_in).sum(dim=(-2, -1))                  # (b, c, h)
    dcum[:, :, -1] += torch.exp(last) * gdot + u.sum(dim=2)
    da = dcum.flip(2).cumsum(dim=2).flip(2)
    ddt = xd + Af * da
    dA = (dtc * da).sum(dim=(0, 1, 2))
    dD = (dyc * xc).sum(dim=(0, 1, 2, 4))

    def rows(t):
        return t.reshape(b, nc * Q, *t.shape[3:])[:, :s]
    return (rows(dx).to(x.dtype), rows(ddt), dA, rows(dB).to(B.dtype),
            rows(dC).to(C.dtype), dD)


def _case(case, dist, seed, dfinal=True, underflow=False):
    """bf16 x, B, C and dy (rounded once), fp32 dt, A, D and dfinal (b, h,
    p, n) or None, as torch tensors; ``underflow``: A*dt = -32 a row, so
    exp(cum) is 0 in fp32 over a 64-row chunk."""
    b, s, h, p, n, _ = case
    x, dt, A, B, C, D = _inputs(case, dist, seed)
    if underflow:
        A = np.array([-16.0, -1.0] * (h // 2), np.float32)
        dt = np.full_like(dt, 2.0)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    final = rng.standard_normal((b, h, p, n)).astype(np.float32)
    bf = torch.bfloat16
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (x, dt, A, B, C, D, dy, final)]
    return (t[0].to(bf), t[1], t[2], t[3].to(bf), t[4].to(bf), t[5],
            t[6].to(bf), t[7] if dfinal else None)


def _jax_grads(args, chunk):
    """The six gradients of JAX's ``ssd_chunked`` (fp32, from the widened
    bf16 inputs) at the model's chunk for s, with the cotangents dy and
    dfinal (zeros for None)."""
    x, dt, A, B, C, D, dy, dfinal = args
    s = x.shape[1]
    ins = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, B, C, D)]
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(
        *a[:5], ssm.jax_chunk(chunk, s), D=a[5]), *ins)
    df = (jnp.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[-1]),
                    jnp.float32) if dfinal is None
          else jnp.asarray(dfinal.numpy()))
    return [torch.from_numpy(np.array(g))
            for g in vjp((jnp.asarray(dy.float().numpy()), df))]


def _shares(got, want):
    """Each gradient's share of its phase-17 limit (bf16 inputs)."""
    return {name: chip_smoke.ssd_backward_deviation(
        torch, name, g, w, "bfloat16")[2]
        for name, g, w in zip(chip_smoke.SSD_GRADS, got, want)}


def _assert_within_limits(args, got, chunk):
    """``got`` within phase 17's limits of ``ref.ssd_scan_backward`` (what
    the card holds the kernel to), and against ``jax.vjp`` each gradient
    within its limit or no farther from JAX than the port's plain version
    is: JAX sums cum in another order, and where A dt is large
    (mamba2's distribution, A down to -16) the plain version's own ddt
    reads up to 2.0x its limit from JAX's."""
    plain = ref.ssd_scan_backward(*args, chunk=chunk)
    near = _shares(got, plain)
    assert max(near.values()) <= 1.0, near
    jax_grads = _jax_grads(args, chunk)
    emulated, own = _shares(got, jax_grads), _shares(plain, jax_grads)
    for name, share in emulated.items():
        assert share <= max(1.0, own[name]), (name, share, own[name])


# (b, s, h, p, n, chunk), distribution: mamba2-370m's widths (a short s),
# the tests' distribution at a ragged s with heads not a multiple of the
# kernel's group, and narrow p and n
EMULATION_CASES = [
    ((1, 128, 4, 64, 128, 64), "mamba2"),
    ((1, 128, 4, 64, 128, 64), "tests"),
    ((2, 200, 3, 32, 64, 64), "tests"),
    ((1, 192, 2, 16, 32, 64), "mamba2"),
]


@pytest.mark.parametrize("dfinal", [True, False])
@pytest.mark.parametrize("case,dist", EMULATION_CASES)
def test_three_terms_hold_phase_17_limits_against_jax(case, dist, dfinal):
    """With three bf16 terms a product every gradient of the emulated
    instance is within its phase-17 limit of ``jax.vjp`` of JAX's
    ``ssd_chunked``, with a cotangent for the final state or none."""
    args = _case(case, dist, seed=EMULATION_CASES.index((case, dist)),
                 dfinal=dfinal)
    got = emulate_backward_tc(*args, chunk=case[5])
    _assert_within_limits(args, got, case[5])
    assert got[0].dtype == got[3].dtype == got[4].dtype == torch.bfloat16


def test_three_terms_where_exp_cum_underflows():
    """A*dt = -32 a row: exp(cum) underflows to 0 within the chunk, every
    decay stays an exp of a difference of cum; the emulation stays finite
    and within the limits of JAX's gradients (whose chunk of 50 keeps cum
    above the underflow)."""
    case = (1, 150, 2, 16, 32, 64)
    args = _case(case, "tests", seed=7, underflow=True)
    got = emulate_backward_tc(*args, chunk=64)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _assert_within_limits(args, got, 64)


def test_three_terms_on_a_ragged_mamba2_batch():
    """mamba2's distribution at b = 2, a ragged s and 3 heads."""
    args = _case((2, 200, 3, 32, 64, 64), "mamba2", seed=3)
    _assert_within_limits(args, emulate_backward_tc(*args, chunk=64), 64)


@pytest.mark.parametrize("dist", ["tests", "mamba2"])
def test_two_terms_miss_the_limits(dist):
    """Every fp32 operand at two bf16 terms (16 bits, a relative error of
    up to 2^-17): ddt, whose dcum sums rows that cancel, leaves its limit
    on both distributions."""
    args = _case((1, 128, 4, 64, 128, 64), dist, seed=1)
    two = _shares(emulate_backward_tc(
        *args, chunk=64, terms={name: 2 for name in PRODUCTS}),
        ref.ssd_scan_backward(*args, chunk=64))
    assert two["ddt"] > 1.0, two


@pytest.mark.parametrize("name,dist", [("MT", "tests"), ("g", "mamba2")])
def test_two_terms_in_one_product_miss(name, dist):
    """One product at two terms, the rest at three, misses on its own: M^T
    (dxdt's intra-chunk part) on standard-normal inputs, g (the state
    gradient in dxdt and dB) on mamba2's.  The other products read up to
    0.99 of a limit at two terms here (S and S^T on dC and dB), too close
    to drop a term: every product keeps three."""
    args = _case((1, 128, 4, 64, 128, 64), dist, seed=1)
    shares = _shares(emulate_backward_tc(*args, chunk=64,
                                         terms={name: 2}),
                     ref.ssd_scan_backward(*args, chunk=64))
    assert shares["ddt"] > 1.0, shares


# --------------------------------------------------------------------------
# the instance rule and the refusals, on CPU tensors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,p,n,chunk,want", [
    (torch.bfloat16, 64, 128, 64, "wgmma"),       # mamba2-370m
    (torch.bfloat16, 16, 16, 64, "wgmma"),
    (torch.bfloat16, 32, 64, 64, "wgmma"),
    (torch.bfloat16, 256, 128, 64, "wgmma"),
    (torch.bfloat16, 192, 256, 64, "wgmma"),
    (torch.bfloat16, 256, 256, 64, "wgmma"),
    (torch.bfloat16, 64, 128, 128, "fma"),        # chunk 128: not taken
    (torch.bfloat16, 64, 128, 32, "fma"),
    (torch.float32, 64, 128, 64, "fma"),          # fp32 takes the FMAs
    (torch.float16, 64, 128, 64, "fma"),
    (torch.bfloat16, 8, 16, 64, "fma"),           # p below 16
    (torch.bfloat16, 24, 16, 64, "fma"),          # p not a multiple of 16
    (torch.bfloat16, 272, 16, 64, "fma"),         # p above 256
    (torch.bfloat16, 64, 40, 64, "fma"),          # n not a multiple of 16
    (torch.bfloat16, 64, 272, 64, "fma"),
])
def test_ssd_backward_instance_rule(dtype, p, n, chunk, want):
    assert ops.ssd_backward_instance(dtype, p, n, chunk) == want


def test_ssd_backward_smem_by_instance():
    """mamba2-370m's training shape: 201,728 bytes a block of the fp32-FMA
    gradient pass (one block an SM), 103,712 of the tensor-core one (two
    an SM: 2 x (103,712 + 1,024) <= 233,472); at p = n = 256 the
    tensor-core pass still fits a block."""
    assert ops.ssd_backward_smem_bytes(64, 64, 128) == 201728
    assert ops.ssd_backward_smem_bytes(64, 64, 128, "fma") == 201728
    tc = ops.ssd_backward_smem_bytes(64, 64, 128, "wgmma")
    assert tc == ((2 * 2 + 2 * 1 + 6) * 8192 + 2 * 1024 + 5 * 256 + 32
                  + 1024 + 1024)
    assert tc == 103712 and 2 * (tc + 1024) <= 233472
    # p = n = 256: one block an SM, within its shared memory
    assert ops.ssd_backward_smem_bytes(64, 256, 256, "wgmma") == 185632


def test_reset_launches_clears_the_ssd_backward_instances():
    ops.ssd_backward_launches["wgmma"] += 2
    ops.ssd_backward_launches["fma"] += 1
    ops.reset_launches()
    assert ops.ssd_backward_launches == {"wgmma": 0, "fma": 0}


def _model_operands(h=4, p=16, n=32, s=70, dtype=torch.bfloat16):
    """x, B, C as column slices of one conv output, as the model hands
    them in; dy dense."""
    buf = torch.zeros(1, s, h * p + 2 * n, dtype=dtype)
    x = buf[..., :h * p].reshape(1, s, h, p)
    return dict(x=x, dt=torch.zeros(1, s, h), A=torch.zeros(h),
                B=buf[..., h * p:h * p + n], C=buf[..., h * p + n:],
                D=torch.zeros(h), dy=torch.zeros(1, s, h, p, dtype=dtype),
                dfinal=None)


def test_aligned_model_slices_choose_the_tensor_core_instance():
    """The model's aligned bf16 slices at chunk 64: ``"wgmma"``, and its
    checks pass; a base off 16 bytes or a pitch that is not a multiple of
    16 bytes in x, B, C or dy sends the call to ``"fma"``, whose checks
    pass."""
    o = _model_operands()
    args = list(o.values())
    assert ops.ssd_backward_instance(torch.bfloat16, 16, 32, 64, o["x"],
                                     o["B"], o["C"], o["dy"]) == "wgmma"
    ops._check_ssd_backward(*args, 64, "wgmma")
    flat = torch.zeros(1 + o["x"].numel(), dtype=torch.bfloat16)
    shifted = flat[1:].view(o["x"].shape)
    wide = torch.zeros(1, 70, 4 * 16 + 2 * 32 + 4, dtype=torch.bfloat16)
    odd_B = wide[..., 64:96]
    for bad in (dict(x=shifted), dict(B=odd_B), dict(C=odd_B),
                dict(dy=flat[1:].view(o["dy"].shape))):
        case = dict(o, **bad)
        assert ops.ssd_backward_instance(
            torch.bfloat16, 16, 32, 64, case["x"], case["B"], case["C"],
            case["dy"]) == "fma"
        ops._check_ssd_backward(*case.values(), 64, "fma")
        with pytest.raises(ValueError, match="16"):
            ops._check_ssd_backward(*case.values(), 64, "wgmma")


@pytest.mark.parametrize("what", ["fp32", "chunk 128", "chunk 32", "p 24",
                                  "unknown"])
def test_forced_tensor_core_instance_refuses_before_a_launch(what):
    """``ops._ssd_backward_launch(..., "wgmma")`` on operands the instance
    does not take raises ValueError in its checks, before the library is
    loaded or a counter moves: fp32, another chunk, a p that is not a
    multiple of 16, an unknown instance."""
    o = _model_operands(s=256)
    chunk, instance = 64, "wgmma"
    if what == "fp32":
        o = _model_operands(s=256, dtype=torch.float32)
    elif what.startswith("chunk"):
        chunk = int(what.split()[1])
    elif what == "p 24":
        o = _model_operands(p=24, s=256)
    else:
        instance = "tensor"
    before = (dict(ops.launches), dict(ops.ssd_backward_launches))
    loads = ops._ssd_backward_lib.cache_info().misses
    with pytest.raises(ValueError, match="tensor-core|instance"):
        ops._ssd_backward_launch(*o.values(), chunk, instance)
    assert (dict(ops.launches), dict(ops.ssd_backward_launches)) == before
    assert ops._ssd_backward_lib.cache_info().misses == loads


def test_cpu_backward_runs_the_plain_version_on_either_rule():
    """On CPU tensors the wrapper is ``ref.ssd_scan_backward`` whichever
    instance the rule names for the card, and no counter moves."""
    args = _case((1, 130, 2, 16, 32, 64), "tests", seed=5)
    assert ops.ssd_backward_instance(torch.bfloat16, 16, 32, 64, args[0],
                                     args[3], args[4], args[6]) == "wgmma"
    before = (dict(ops.launches), dict(ops.ssd_backward_launches))
    got = ops.ssd_scan_backward(*args, chunk=64)
    want = ref.ssd_scan_backward(*args, chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (dict(ops.launches), dict(ops.ssd_backward_launches)) == before


# --------------------------------------------------------------------------
# chip_smoke.py's phase 18 and its readers of the build, rehearsed
# --------------------------------------------------------------------------

def test_chip_smoke_backward_instance_checks_rehearsal():
    """Phase 18's forced-instance checks on CPU tensors: only the cases
    the tensor-core instance takes run (bf16, chunk 64), each under both
    names, where the wrapper's plain version reads 0 and the control is
    far above every limit; nothing is timed."""
    devs = {}
    cases = [(1, 64, 2, 8, 16, 32), (1, 70, 2, 16, 32, 64),
             (1, 128, 1, 16, 16, 128)]
    rows = chip_smoke.ssd_backward_instance_checks(torch, ops, ref, "cpu",
                                                   devs, cases=cases)
    assert [r["case"] for r in rows] == [list(cases[1])]
    assert devs["ssd_scan_backward"] == {"bfloat16": 0.0}
    for inst in ops.SSD_BACKWARD_INSTANCES:
        for name, limit in chip_smoke.SSD_BACKWARD_TOL.items():
            assert rows[0][inst][name]["share"] == 0.0
            assert rows[0][inst]["control"][name] > 100 * limit
        assert "ms" not in rows[0][inst]


def test_chip_smoke_forces_the_backward_instance():
    """Inside ``forced_backward_instance`` the rule answers the forced
    name for any operands, and it is restored after."""
    rule = ops.ssd_backward_instance
    with chip_smoke.forced_backward_instance(ops, "fma"):
        assert ops.ssd_backward_instance(torch.bfloat16, 64, 128, 64) == \
            "fma"
    assert ops.ssd_backward_instance is rule
    assert rule(torch.bfloat16, 64, 128, 64) == "wgmma"


def test_chip_smoke_sums_the_backward_kernels_of_a_split():
    """Both instances' kernels (and the shared reduction) count, and
    nothing else of a step does."""
    split = {"bwd_tc_grad_pass<2, 1>": 1.0, "bwd_grad_pass<__nv_bfloat16>":
             2.0, "(anonymous namespace)::bwd_state_pass((anonymous "
             "namespace):": 0.5, "tc::bwd_tc_state_pass((anonymous "
             "namespace)::Args)": 0.25, "bwd_reduce<__nv_bfloat16>": 0.125,
             "ssd_output_pass<64, 2>": 8.0, "nvjet_tst_192x192": 16.0}
    assert chip_smoke.backward_kernels_ms(split) == 3.875


def test_chip_smoke_reads_the_tensor_core_backward_build(monkeypatch):
    """The backward's tensor-core kernels from cuobjdump's counts and
    ptxas's report: every instance present with wgmma, pipelined and
    without a spill passes; a missing wgmma, a wait after each, or a
    spill fails the run."""
    fns = (["_ZN2tc17bwd_tc_chunk_passEN48_GLOBAL__N__e6_ArgsE"]
           + [f"_ZN2tc16bwd_tc_grad_passILi{n}ELi{p}EEEvN48_GLOBAL__N__e6_"
              f"4ArgsE" for n in range(1, 5) for p in range(1, 5)])
    sass = "".join(
        f"\t\tFunction : {fn}\n"
        "        /*0100*/  LDGSTS.E.BYPASS.128 [R1], desc[UR8][R2.64] ;\n"
        "        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ ;\n"
        "        /*0210*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR9], R24 ;\n"
        "        /*0220*/  WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n"
        for fn in fns)
    clean = "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    entries = [("bwd_tc_chunk_pass", "_ZN2tc17bwd_tc_chunk_passEN48_Args")] + [
        (f"bwd_tc_grad_pass<{n}, {p}>",
         f"_ZN2tc16bwd_tc_grad_passILi{n}ELi{p}EEEvN48_4ArgsE")
        for n in range(1, 5) for p in range(1, 5)]

    def report(spilled=None):
        return "".join(
            f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\n"
            + ("    8 bytes stack frame, 8 bytes spill stores, 8 bytes "
               "spill loads\n" if name == spilled else clean + "\n")
            + "ptxas info    : Used 200 registers, used 1 barriers\n"
            for name, mangled in entries)

    class Build:
        log = report()

        def build_log(self, name):
            assert name == "ssd_backward"
            return self.log
    build = Build()
    monkeypatch.setattr(chip_smoke, "disassemble", lambda b, name: sass)
    found = chip_smoke.ssd_backward_tensor_core_sass(build)
    assert len(found) == 17
    assert found["bwd_tc_grad_pass<2, 1>"]["HGMMA"] == 2
    assert found["bwd_tc_grad_pass<2, 1>"]["registers"] == 200
    build.log = report(spilled="bwd_tc_grad_pass<4, 4>")
    with pytest.raises(chip_smoke.SmokeFailure, match="spills"):
        chip_smoke.ssd_backward_tensor_core_sass(build)
    build.log = report()
    serial = sass.replace("R24, gdesc[UR8], RZ ;\n",
                          "R24, gdesc[UR8], RZ ;\n        /*0208*/  "
                          "WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n", 1)
    monkeypatch.setattr(chip_smoke, "disassemble", lambda b, name: serial)
    with pytest.raises(chip_smoke.SmokeFailure, match="serialized"):
        chip_smoke.ssd_backward_tensor_core_sass(build)
    monkeypatch.setattr(chip_smoke, "disassemble",
                        lambda b, name: sass.replace("HGMMA", "FFMA", 2))
    with pytest.raises(chip_smoke.SmokeFailure, match="no wgmma"):
        chip_smoke.ssd_backward_tensor_core_sass(build)


def test_chip_smoke_holds_the_forward_sass_to_its_earlier_counts():
    """The forward's passes as recorded before the helpers moved: every
    pass the build checks has its counts, each wgmma-pipelined; the same
    counts pass, one changed count or a missing pass fails the run."""
    want = {f"ssd_chunk_pass<{Q}>" for Q in (64, 128)} | {
        f"ssd_output_pass<{Q}, {NP}>" for Q in (64, 128)
        for NP in (1, 2, 3, 4)}
    assert set(chip_smoke.FORWARD_SSD_SASS) == want
    assert all(len(c) == len(chip_smoke.SSD_OPCODES) and c[1] < c[0]
               for c in chip_smoke.FORWARD_SSD_SASS.values())
    found = {name: dict(zip(chip_smoke.SSD_OPCODES, c))
             for name, c in chip_smoke.FORWARD_SSD_SASS.items()}
    chip_smoke.forward_sass_unchanged(found)
    found["ssd_chunk_pass<64>"]["HGMMA"] += 1
    with pytest.raises(chip_smoke.SmokeFailure, match="changed"):
        chip_smoke.forward_sass_unchanged(found)
    del found["ssd_chunk_pass<64>"]
    with pytest.raises(chip_smoke.SmokeFailure, match="changed"):
        chip_smoke.forward_sass_unchanged(found)
