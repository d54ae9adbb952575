"""Torch port, the tensor-core ``ssd_scan`` instance on the CPU: its
instance rule, the CPU wrapper (the plain version, no launch), and a plain
emulation of its arithmetic — chunk-parallel SSD in three passes with each
fp32 operand of the tensor cores (the masked scores, the decayed B,
state_in) cut into bf16 terms — held to the port's one-bf16-ulp check
against ``ref.ssd_scan`` and the JAX package's Pallas ``ssd_scan``
(interpret mode, as ``tests/test_kernels.py`` runs it).  Three terms pass
on both input distributions; two do not, which records why the kernel
pays for three.  The CUDA kernel itself runs only on a card:
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch import configs
from repro_torch.kernels import ops, ref
from _torch_cases import one_thread  # noqa: F401

BF16_ULP = chip_smoke.BF16_ULP


def _inputs(case, dist, seed):
    """numpy inputs of one case.  ``"tests"``: tests/test_kernels.py's
    distribution (standard-normal x, B, C; dt = |N| 0.1 + 0.01; A =
    -(|N| + 0.5); D = |N|).  ``"mamba2"``: as mamba2-370m forms them (x, B,
    C column slices of silu(0.5 N); dt = softplus(N); A = -linspace(1, 16,
    h); D = 1)."""
    b, s, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if dist == "mamba2":
        buf = 0.5 * rng.standard_normal((b, s, h * p + 2 * n)).astype(f32)
        buf = buf / (1.0 + np.exp(-buf))
        x = buf[..., :h * p].reshape(b, s, h, p)
        B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:]
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f32)
        A = -np.linspace(1.0, 16.0, h).astype(f32)
        D = np.ones(h, f32)
    else:
        x = rng.standard_normal((b, s, h, p)).astype(f32)
        B = rng.standard_normal((b, s, n)).astype(f32)
        C = rng.standard_normal((b, s, n)).astype(f32)
        dt = (np.abs(rng.standard_normal((b, s, h))) * 0.1 + 0.01).astype(f32)
        A = -(np.abs(rng.standard_normal(h)) + 0.5).astype(f32)
        D = np.abs(rng.standard_normal(h)).astype(f32)
    return [np.ascontiguousarray(a) for a in (x, dt, A, B, C, D)]


def _torch(arrays):
    """bf16 x, B, C (rounded once from fp32); fp32 dt, A, D."""
    x, dt, A, B, C, D = map(torch.from_numpy, arrays)
    bf = torch.bfloat16
    return x.to(bf), dt, A, B.to(bf), C.to(bf), D


def _terms(v, k):
    """v as k bf16-valued fp32 terms, hi first: each the bf16 rounding of
    what the earlier ones leave (the subtractions are exact)."""
    out = []
    for _ in range(k):
        t = v.to(torch.bfloat16).to(torch.float32)
        out.append(t)
        v = v - t
    return out


def _product(terms, other, eq):
    """The tensor cores' sum over the terms, lo first: each term's product
    with a bf16 operand is exact, the sums fp32."""
    return sum(torch.einsum(eq, t, other) for t in reversed(terms))


def emulate_tc(x, dt, A, B, C, D, *, chunk, terms=(3, 3, 3)):
    """The arithmetic of ``csrc/ssd_scan.cu``'s tensor-core instance in
    plain torch, with ``terms`` bf16 terms for (the masked scores, the
    decayed B, state_in):
      (a) cum in index order; local (n, p) = (B * (dt * exp(cum[-1] -
          cum)))^T @ x per chunk;
      (b) state_in[c] = state; state = state * exp(cum[-1]) + local[c];
      (c) y = ((C B^T * exp(cum_i - cum_j) [j <= i]) * dt_j) @ x
          + exp(cum) * (C @ state_in^T) + D * x, rounded once.
    Returns (y in x's dtype, final state (b, h, p, n) fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    Q = chunk
    nc = -(-s // Q)
    pad = nc * Q - s
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), B.to(f32), C.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    xc = xf.reshape(b, nc, Q, h, p)
    dtc = dtf.reshape(b, nc, Q, h)
    Bc, Cc = Bf.reshape(b, nc, Q, n), Cf.reshape(b, nc, Q, n)
    cum = ref._sequential_cumsum(dtc * A.to(f32), dim=2)       # (b, c, Q, h)
    # (a) the chunk pass
    decay = dtc * torch.exp(cum[:, :, -1:, :] - cum)
    bdec = Bc[..., None] * decay[:, :, :, None, :]              # (b, c, j, n, h)
    local = _product(_terms(bdec, terms[1]), xc, "bcjnh,bcjhp->bchnp")
    # (b) the state pass
    state = torch.zeros((b, h, n, p), dtype=f32)
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = state * torch.exp(cum[:, c, -1])[..., None, None] \
            + local[:, c]
    state_in = torch.stack(state_in, 1)                         # (b, c, h, n, p)
    # (c) the output pass
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri[:, :, None], torch.exp(
        cum[:, :, :, None, :] - cum[:, :, None, :, :]), 0.0)
    scores = G[..., None] * L * dtc[:, :, None, :, :]          # (b, c, i, j, h)
    intra = _product(_terms(scores, terms[0]), xc, "bcijh,bcjhp->bcihp")
    carry = sum(torch.einsum("bcin,bchnp->bcihp", Cc, t)
                for t in reversed(_terms(state_in, terms[2])))
    y = intra + carry * torch.exp(cum)[..., None] + D.to(f32)[:, None] * xc
    return (y.reshape(b, nc * Q, h, p)[:, :s].to(x.dtype),
            state.transpose(-1, -2).contiguous())


def _shares(got, want):
    """(y, state) as shares of chip_smoke.ssd_deviation's bf16 limits."""
    (_, y_share), (_, s_share) = chip_smoke.ssd_deviation(
        torch, got, want, "bfloat16")
    return y_share, s_share


# --------------------------------------------------------------------------
# the instance rule and the CPU wrapper
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,p,n,chunk,want", [
    (torch.bfloat16, 64, 128, 64, "wgmma"),       # mamba2-370m
    (torch.bfloat16, 64, 128, 128, "wgmma"),
    (torch.bfloat16, 16, 16, 64, "wgmma"),
    (torch.bfloat16, 256, 256, 128, "wgmma"),
    (torch.bfloat16, 32, 64, 64, "wgmma"),
    (torch.float32, 64, 128, 64, "fma"),          # fp32 takes the FMA walk
    (torch.float16, 64, 128, 64, "fma"),
    (torch.bfloat16, 64, 128, 32, "fma"),         # chunk not 64 or 128
    (torch.bfloat16, 32, 32, 16, "fma"),
    (torch.bfloat16, 8, 16, 64, "fma"),           # p below 16
    (torch.bfloat16, 24, 16, 64, "fma"),          # p not a multiple of 16
    (torch.bfloat16, 272, 16, 64, "fma"),         # p above 256
    (torch.bfloat16, 64, 40, 64, "fma"),          # n not a multiple of 16
    (torch.bfloat16, 64, 8, 64, "fma"),
    (torch.bfloat16, 64, 272, 64, "fma"),
])
def test_ssd_instance_rule(dtype, p, n, chunk, want):
    assert ops.ssd_instance(dtype, p, n, chunk) == want


def test_mamba2_configs_pick_their_instances():
    """Full mamba2-370m (bf16, p 64, n 128, chunk 64) runs on the tensor
    cores; the reduced config's chunk 16 takes the FMA walk, in bf16 too."""
    full = configs.get("mamba2_370m")
    assert ops.ssd_instance(torch.bfloat16, full.ssm_headdim, full.ssm_state,
                            full.ssm_chunk) == "wgmma"
    small = configs.get_reduced("mamba2_370m")
    assert small.ssm_chunk == 16
    for dtype in (torch.bfloat16, torch.float32):
        assert ops.ssd_instance(dtype, small.ssm_headdim, small.ssm_state,
                                small.ssm_chunk) == "fma"


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    """A bf16 case the tensor-core instance would take: on CPU tensors the
    wrapper is ref.ssd_scan, bit for bit, and no counter moves."""
    args = _torch(_inputs((2, 200, 3, 32, 64, 64), "tests", seed=3))
    before = dict(ops.launches), dict(ops.ssd_launches)
    got = ops.ssd_scan(*args, chunk=64)
    want = ref.ssd_scan(*args, chunk=64)
    assert (dict(ops.launches), dict(ops.ssd_launches)) == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_reset_launches_clears_the_ssd_instances():
    ops.ssd_launches["wgmma"] += 3
    ops.reset_launches()
    assert ops.ssd_launches == {"wgmma": 0, "fma": 0}


def test_ssd_scratch_matches_the_kernel_layout():
    """Each chunk's (n, p) state and its last cum: 33.5 MB at mamba2-370m's
    S = 2048."""
    assert ops.ssd_scratch_floats(1, 2048, 32, 64, 128, 64) == \
        32 * 32 * (128 * 64 + 1)
    assert ops.ssd_scratch_floats(2, 200, 3, 32, 64, 64) == \
        2 * 4 * 3 * (64 * 32 + 1)


def test_wgmma_checks_alignment_and_strides_on_cpu_tensors():
    """The tensor-core instance's operand checks, run on CPU tensors: a
    base off 16 bytes or a stride that is not a multiple of 8 elements
    raises; the model's column slices of one conv output pass."""
    h, p, n = 4, 16, 32
    buf = torch.zeros(1, 70, h * p + 2 * n, dtype=torch.bfloat16)
    x = buf[..., :h * p].reshape(1, 70, h, p)
    B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    rest = (torch.zeros(1, 70, h), torch.zeros(h))
    ok = (x, rest[0], rest[1], B, C, rest[1])
    ops._check_ssd(*ok, 64, "wgmma")
    flat = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check_ssd(shifted, *ok[1:], 64, "wgmma")
    wide = torch.zeros(1, 70, h * p + 2 * n + 4, dtype=torch.bfloat16)
    odd = wide[..., :h * p].reshape(1, 70, h, p)
    with pytest.raises(ValueError, match="16 bytes"):
        ops._check_ssd(odd, *ok[1:], 64, "wgmma")
    with pytest.raises(ValueError, match="tensor-core instance"):
        ops._check_ssd(*ok, 32, "wgmma")


def test_misaligned_bf16_operands_choose_the_fma_instance():
    """Given x, B and C, ``ssd_instance`` sends a bf16 call the tensor-core
    instance would take, but with a base off 16 bytes or a pitch that is
    not a multiple of 16 bytes, to the fp32-FMA chunk walk, whose checks
    pass; the model's aligned column slices stay on the tensor cores."""
    h, p, n = 4, 16, 32
    buf = torch.zeros(1, 70, h * p + 2 * n, dtype=torch.bfloat16)
    x = buf[..., :h * p].reshape(1, 70, h, p)
    B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    dt, A = torch.zeros(1, 70, h), torch.zeros(h)
    assert ops.ssd_instance(torch.bfloat16, p, n, 64, x, B, C) == "wgmma"
    flat = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape)
    wide = torch.zeros(1, 70, h * p + 2 * n + 4, dtype=torch.bfloat16)
    odd_B = wide[..., h * p:h * p + n]
    for bad in ((shifted, B, C), (x, odd_B, C), (x, B, odd_B)):
        assert ops.ssd_instance(torch.bfloat16, p, n, 64, *bad) == "fma"
        ops._check_ssd(bad[0], dt, A, bad[1], bad[2], A, 64, "fma")
        with pytest.raises(ValueError, match="16"):
            ops._check_ssd(bad[0], dt, A, bad[1], bad[2], A, 64, "wgmma")
    assert ops.ssd_instance(torch.bfloat16, p, n, 64, x, B, None) == "fma"


# --------------------------------------------------------------------------
# the emulated arithmetic against the plain version and the Pallas kernel
# --------------------------------------------------------------------------

# (b, s, h, p, n, chunk): s a multiple of the chunk (the JAX wrapper
# asserts it); mamba2-370m's widths, a small group of its shapes, and
# the edges the tensor-core instance takes (b = 2 with 3 heads, chunk 128
# at p = n = 16)
JAX_CASES = [
    ((1, 128, 32, 64, 128, 64), "mamba2"),
    ((1, 256, 8, 64, 128, 64), "mamba2"),
    ((1, 256, 8, 64, 128, 64), "tests"),
    ((2, 192, 3, 32, 64, 64), "tests"),
    ((1, 256, 4, 16, 16, 128), "tests"),
]


@pytest.mark.parametrize("case,dist", JAX_CASES)
def test_three_terms_hold_the_one_ulp_limit(case, dist):
    """With three bf16 terms per fp32 operand the emulated y is within one
    bf16 ulp (+1e-6) of ref.ssd_scan's, the final state within 5e-5 (1 +
    |s|) of its state, and y within one ulp of the Pallas kernel's y —
    or no farther from it than ref.ssd_scan's own y is: the Pallas kernel
    sums cum in another order, and at (1, 256, 8, 64, 128, 64) the port's
    plain version is itself 1.4x (standard-normal inputs) and 2.2x
    (mamba2's) the one-ulp limit from it."""
    arrays = _inputs(case, dist, seed=0)
    args = _torch(arrays)
    chunk = case[5]
    got = emulate_tc(*args, chunk=chunk)
    plain = ref.ssd_scan(*args, chunk=chunk)
    y_share, s_share = _shares(got, plain)
    assert y_share <= 1.0 and s_share <= 1.0
    jx, jdt, jA, jB, jC, jD = (jnp.asarray(a) for a in arrays)
    bf = jnp.bfloat16
    pallas = np.asarray(jax_ssd_scan(jx.astype(bf), jdt, jA, jB.astype(bf),
                                     jC.astype(bf), jD, chunk=chunk),
                        np.float32)
    limit = BF16_ULP * np.abs(pallas) + 1e-6

    def share(y):
        return (np.abs(y.float().numpy() - pallas) / limit).max()
    assert share(got[0]) <= max(1.0, share(plain[0]))


def test_three_terms_on_a_ragged_batch():
    """b = 2, a ragged s (the padded rows are dt = 0) and heads not a
    multiple of the kernel's group, against the plain version."""
    args = _torch(_inputs((2, 200, 3, 32, 64, 64), "tests", seed=1))
    got = emulate_tc(*args, chunk=64)
    y_share, s_share = _shares(got, ref.ssd_scan(*args, chunk=64))
    assert y_share <= 1.0 and s_share <= 1.0


@pytest.mark.parametrize("terms", [(2, 2, 2), (2, 3, 3), (3, 2, 3),
                                   (3, 3, 2)],
                         ids=["all", "scores", "decayed_B", "state_in"])
def test_two_terms_miss_the_limit_on_the_tests_distribution(terms):
    """Any one of the three operands at two bf16 terms (16 bits) breaks the
    one-ulp limit on standard-normal inputs, where y is a small sum of
    large terms: so the kernel cuts each into three."""
    case = (1, 256, 8, 64, 128, 64)
    args = _torch(_inputs(case, "tests", seed=0))
    got = emulate_tc(*args, chunk=64, terms=terms)
    y_share, _ = _shares(got, ref.ssd_scan(*args, chunk=64))
    assert y_share > 1.0


def test_one_term_misses_by_orders_of_magnitude():
    """bf16 scores, decayed B and state_in (one term each): y is hundreds
    of ulps off on mamba2-370m's own distribution."""
    case = (1, 128, 32, 64, 128, 64)
    args = _torch(_inputs(case, "mamba2", seed=0))
    got = emulate_tc(*args, chunk=64, terms=(1, 1, 1))
    y_share, s_share = _shares(got, ref.ssd_scan(*args, chunk=64))
    assert y_share > 100.0 and s_share > 1.0


# --------------------------------------------------------------------------
# chip_smoke.py's readers of the build
# --------------------------------------------------------------------------

def test_chip_smoke_reads_the_tensor_core_ssd_build(monkeypatch):
    """The ptxas lines of the passes (two template arguments, or none) and
    cuobjdump's counts per pass; a pass with no HGMMA, or a wait after
    each of its HGMMAs, fails the run."""
    assert chip_smoke.ptxas_report(
        "ptxas info    : Compiling entry function '_ZN2tc15ssd_output_passILi"
        "64ELi2EEEvNS_4ArgsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 218 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN2tc14ssd_state_passEPfPK"
        "fS0_iiii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 100 registers, used 0 barriers\n") == [
        ("ssd_output_pass<64, 2>", 218,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("ssd_state_pass", 100,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
    fns = ([f"_ZN2tc14ssd_chunk_passILi{Q}EEEvNS_4ArgsE" for Q in (64, 128)]
           + [f"_ZN2tc15ssd_output_passILi{Q}ELi{NP}EEEvNS_4ArgsE"
              for Q in (64, 128) for NP in (1, 2, 3, 4)])
    sass = "".join(
        f"\t\tFunction : {fn}\n"
        "        /*0100*/  LDGSTS.E.BYPASS.128 [R1], desc[UR8][R2.64] ;\n"
        "        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ ;\n"
        "        /*0210*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR9], R24 ;\n"
        "        /*0220*/  WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n"
        for fn in fns)
    monkeypatch.setattr(chip_smoke, "disassemble", lambda build, name: sass)
    found = chip_smoke.ssd_tensor_core_sass(None)
    assert len(found) == 10
    assert found["ssd_output_pass<128, 4>"] == {
        "HGMMA": 2, "WARPGROUP.DEPBAR": 1, "UTMALDG": 0, "UBLKCP": 0,
        "LDGSTS": 1}
    no_wgmma = sass.replace("HGMMA", "FFMA", 2)
    monkeypatch.setattr(chip_smoke, "disassemble",
                        lambda build, name: no_wgmma)
    with pytest.raises(chip_smoke.SmokeFailure, match="no wgmma"):
        chip_smoke.ssd_tensor_core_sass(None)
    # a wait after every wgmma: ptxas serialized them
    serial = sass.replace(
        "R24, gdesc[UR8], RZ ;\n",
        "R24, gdesc[UR8], RZ ;\n        /*0208*/  WARPGROUP.DEPBAR.LE gsb0,"
        " 0x0 ;\n", 1)
    monkeypatch.setattr(chip_smoke, "disassemble",
                        lambda build, name: serial)
    with pytest.raises(chip_smoke.SmokeFailure, match="serialized"):
        chip_smoke.ssd_tensor_core_sass(None)


def test_chip_smoke_lists_the_instances_that_take_a_case():
    """Each SSD case runs on the wrapper's instance first, then on the
    fp32-FMA one wherever its shared memory fits."""
    assert chip_smoke.ssd_instances(torch, ops, (1, 2048, 32, 64, 128, 64),
                                    "bfloat16") == ["wgmma", "fma"]
    assert chip_smoke.ssd_instances(torch, ops, (1, 2048, 32, 64, 128, 64),
                                    "float32") == ["fma"]
    assert chip_smoke.ssd_instances(torch, ops, (1, 96, 4, 32, 128, 32),
                                    "bfloat16") == ["fma"]
    # chunk 128 at n = 128 is past the FMA walk's shared memory
    assert chip_smoke.ssd_instances(torch, ops, (1, 256, 2, 64, 128, 128),
                                    "bfloat16") == ["wgmma"]
    assert all(ops.ssd_instance(torch.bfloat16, *c[3:]) == "wgmma"
               for c in chip_smoke.SSD_CASES[-3:])


def test_chip_smoke_ssd_backward_checks_rehearsal():
    """chip_smoke's phase 17 checks on CPU tensors at small shapes: the
    wrapper runs the plain version, so every reading is 0, and each
    control (dy one row later) is far above its limit."""
    devs = {}
    readings = chip_smoke.ssd_backward_checks(
        torch, ops, ref, "cpu", devs,
        cases=[(1, 64, 2, 8, 16, 32), (1, 70, 3, 16, 32, 16)])
    assert len(readings) == 8
    assert [(r["dtype"], r["dfinal"]) for r in readings[:4]] == [
        ("float32", False), ("float32", True), ("bfloat16", False),
        ("bfloat16", True)]
    assert devs["ssd_scan_backward"] == {"float32": 0.0, "bfloat16": 0.0}
    for r in readings:
        for name, limit in chip_smoke.SSD_BACKWARD_TOL.items():
            assert r[name]["share"] == 0.0
            assert r["control"][name] > 100 * limit


def test_chip_smoke_ssd_backward_bound_by_hand():
    """``ssd_backward_work`` at (b, s, h, p, n, chunk) = (1, 10, 2, 4, 8, 4)
    in bf16 with a dfinal, worked out by hand: chunks of 4, 4 and 2 rows
    give 10 + 10 + 3 = 23 pairs j <= i; flops 2 (2 (6·10·4·8 + 2·23·4 +
    2·23·8) + 23·8) = 10,256; bytes (3·10·2·4 + 4·10·8)·2 + 2·10·2·4 +
    4·2·4 + 2·4·8·4 = 1,568, which bound it.  At mamba2-370m's training
    shape (8, 2048, 32, 64, 128, 64) without a dfinal the bytes bound it
    too, barely: 222,298,624 bytes (0.0664 ms) against 6.48e10 flops at
    the bf16 peak (0.0655 ms)."""
    assert chip_smoke.ssd_backward_work(1, 10, 2, 4, 8, 4, 2) == (10256,
                                                                   1568)
    ms, by = chip_smoke.ssd_backward_bound(1, 10, 2, 4, 8, 4, 2)
    assert by == "bytes" and abs(ms - 1e3 * 1568 / 3.35e12) < 1e-15
    flops, nbytes = chip_smoke.ssd_backward_work(
        *chip_smoke.SSD_TRAIN_CASE, 2, dfinal=False)
    assert nbytes == 222298624
    assert flops == 2 * 8 * (32 * (6 * 2048 * 64 * 128 + 2 * 66560 * 64
                                   + 2 * 66560 * 128) + 66560 * 128)
    ms, by = chip_smoke.ssd_backward_bound(*chip_smoke.SSD_TRAIN_CASE, 2,
                                           dfinal=False)
    assert by == "bytes" and abs(ms - 1e3 * nbytes / 3.35e12) < 1e-12
    # fp32 inputs: the fp32 peak, no tensor cores
    ms, by = chip_smoke.ssd_backward_bound(*chip_smoke.SSD_TRAIN_CASE, 4)
    assert by == "operations"


def test_chip_smoke_lists_the_ssd_backward_kernel():
    """The kernels line names the new kernel, its source and what it
    replaces (no Pallas kernel: XLA autodiff of ssd_chunked), and every
    kernel of ``ops.KERNELS`` has both entries."""
    assert chip_smoke.REPLACES["ssd_scan_backward"] == (
        "no Pallas kernel: XLA autodiff of repro.models.ssm.ssd_chunked "
        "(src/repro/models/ssm.py:53-106)")
    assert chip_smoke.SOURCES["ssd_scan_backward"] == \
        "src/repro_torch/kernels/csrc/ssd_backward.cu"
    assert set(chip_smoke.REPLACES) == set(chip_smoke.SOURCES) == set(
        ops.KERNELS)
    assert all((chip_smoke.ROOT / path).exists()
               for path in chip_smoke.SOURCES.values())
    assert chip_smoke.SSD_BACKWARD_CASES[-1] == (8, 2048, 32, 64, 128, 64)
    assert set(chip_smoke.SSD_GRADS) == {"dx", "ddt", "dA", "dB", "dC",
                                         "dD"}


def test_chip_smoke_counts_the_plain_scans(monkeypatch):
    """``counted_plain_scan`` counts every call of a plain scan inside its
    block (on the CPU the wrapper and the model reach them) and restores
    them after; ``autograd_ssd`` is ``ssd_chunked`` at JAX's chunk."""
    from repro_torch.models import ssm
    cfg = configs.get_reduced("mamba2_370m")
    args = _torch(_inputs((1, 46, 2, 8, 16, 16), "tests", seed=1))
    kept = (ref.ssd_scan, ref.ssd_scan_backward, ssm.ssd_chunked)
    with chip_smoke.counted_plain_scan(ref, ssm) as calls:
        ops.ssd_scan(*args, chunk=16)
        y, f = ssm.ssd(*args, cfg)
        ops.ssd_scan_backward(*args, torch.ones_like(args[0]), chunk=16)
    assert dict(calls) == {"ssd_scan": 1, "ssd_chunked": 1,
                           "ssd_scan_backward": 1}
    assert (ref.ssd_scan, ref.ssd_scan_backward, ssm.ssd_chunked) == kept
    wy, wf = chip_smoke.autograd_ssd(*args, cfg)
    assert torch.equal(y, wy) and torch.equal(f, wf)


def test_profile_ssd_refuses_to_run_without_a_card(monkeypatch):
    """The SSD profiler measures the card only: without one it exits with
    a message instead of timing anything on the CPU."""
    from repro_torch.launch import profile_ssd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_ssd.main(["--prompts", "64"])
