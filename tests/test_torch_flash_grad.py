"""Torch port, the gradient of flash attention on the CPU:
``ref.mha_backward`` (the closed form of the ``flash_attention_backward``
kernel, which ``ops.flash_attention_backward`` runs for CPU tensors) and
the ``ops.FlashAttention`` autograd Function, against torch's autograd
of the model's plain ``attention._attend`` and against ``jax.vjp`` of
``repro.kernels.ref.mha``: GQA, causal, sliding-window and keys of their
own length (Sk != S, non-causal), at D = 64, 128 and 256.  The kernel
itself is held to ``ref.mha_backward`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 15)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.models import attention
from _torch_cases import one_thread  # noqa: F401

# fp32: the same fp32 closed form summed in another order than autograd's
# (and XLA's) chain of products.
ATOL = 1e-5
# (B, H, KV, S, Sk, D, causal, window)
CASES = [
    (2, 4, 2, 48, 48, 64, True, None),      # GQA, causal
    (1, 6, 3, 40, 40, 64, True, 7),         # a window
    (1, 4, 4, 33, 33, 128, False, None),    # no mask
    (2, 4, 1, 24, 37, 64, False, None),     # keys of their own length
    (1, 2, 1, 30, 30, 256, True, 9),        # D = 256 under a window
    (1, 4, 2, 21, 21, 128, False, 5),       # a window without causal
]


def _inputs(case, seed=0):
    B, H, KV, S, Sk, D = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _autograd_of_attend(q, k, v, do, causal, window):
    """dq, dk, dv of the model's plain attention (B, S, heads, D layout)
    by torch's autograd, returned as (B, heads, S, D)."""
    qt, kt, vt = (torch.tensor(a).transpose(1, 2).requires_grad_()
                  for a in (q, k, v))
    out = attention._attend(qt, kt, vt, torch.arange(q.shape[2]),
                            torch.arange(k.shape[2]), causal=causal,
                            window=window)
    out.backward(torch.tensor(do).transpose(1, 2))
    return [t.grad.transpose(1, 2) for t in (qt, kt, vt)]


@pytest.mark.parametrize("case", CASES)
def test_mha_backward_matches_autograd_of_attend(case):
    causal, window = case[6], case[7]
    q, k, v, do = _inputs(case)
    want = _autograd_of_attend(q, k, v, do, causal, window)
    qt, kt, vt, dot = map(torch.tensor, (q, k, v, do))
    o = ref.mha(qt, kt, vt, causal=causal, window=window)
    before = dict(ops.launches)
    via_wrapper = ops.flash_attention_backward(qt, kt, vt, o, dot,
                                               causal=causal, window=window)
    assert ops.launches == before          # the CPU runs the plain version
    for got in (ref.mha_backward(qt, kt, vt, o, dot, causal=causal,
                                 window=window), via_wrapper):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == c[4]])
def test_mha_backward_matches_jax_vjp(case):
    """Against ``jax.vjp`` of JAX's oracle (one length for q and kv; its
    masked logits are -inf where the port's are -1e30, the same softmax
    wherever a row sees a key)."""
    causal, window = case[6], case[7]
    q, k, v, do = _inputs(case, seed=1)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha(a, b, c, causal=causal,
                                              window=window),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = map(torch.tensor, (q, k, v, do))
    o = ref.mha(qt, kt, vt, causal=causal, window=window)
    got = ref.mha_backward(qt, kt, vt, o, dot, causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_flash_function_backward_on_cpu_tensors(case):
    """``ops.FlashAttention`` on CPU tensors: the plain forward and
    ``ref.mha_backward``, equal to autograd of ``_attend`` within ATOL; in
    bf16 the grads come back in bf16, equal to the closed form on the
    same bf16 inputs with delta = rowsum(do * o) from the unrounded output
    (the forward's ``o32``), and within one bf16 ulp (+ 1e-6 of the
    largest entry) of the same closed form on fp32 copies of them: each
    gradient is rounded once."""
    causal, window = case[6], case[7]
    q, k, v, do = _inputs(case, seed=2)
    want = _autograd_of_attend(q, k, v, do, causal, window)
    for dtype in (torch.float32, torch.bfloat16):
        ts = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
        dot = torch.tensor(do).to(dtype)
        out = ops.FlashAttention.apply(*ts, causal, window, None)
        assert out.grad_fn is not None
        out.backward(dot)
        grads = [t.grad for t in ts]
        assert all(g.dtype == dtype for g in grads)
        if dtype == torch.float32:
            for g, w in zip(grads, want):
                torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
            continue
        det = [t.detach() for t in ts]
        full = ref.mha(*(t.float() for t in det), causal=causal,
                       window=window)
        assert torch.equal(full.to(dtype), out.detach())
        delta = (dot.float() * full).sum(-1)
        closed = ref.mha_backward(*det, out.detach(), dot, causal=causal,
                                  window=window, delta=delta)
        for g, c in zip(grads, closed):
            assert torch.equal(g, c)
        wide = ref.mha_backward(*(t.float() for t in det), full,
                                dot.float(), causal=causal, window=window)
        for g, w in zip(grads, wide):
            limit = 2.0 ** -7 * w.abs() + 1e-6 * float(w.abs().max())
            assert bool(((g.float() - w).abs() <= limit).all())


def test_flash_function_without_grad_is_the_plain_call():
    """With no input requiring grad (serving) the call is the wrapper's:
    no graph."""
    q, k, v, _ = _inputs(CASES[0])
    ts = list(map(torch.tensor, (q, k, v)))
    out = ops.FlashAttention.apply(*ts, True, None, None)
    assert out.grad_fn is None
    assert torch.equal(out, ops.flash_attention(*ts, causal=True))


def test_backward_refuses_what_the_forward_refuses():
    q, k, v, do = _inputs(CASES[3])
    qt, kt, vt, dot = map(torch.tensor, (q, k, v, do))
    with pytest.raises(ValueError):
        ref.mha_backward(qt, kt, vt, dot, dot, causal=True)


def test_chip_smoke_backward_checks_rehearsal(monkeypatch):
    """chip_smoke's phase 15 checks on CPU tensors at small shapes of its
    cases: the wrapper runs the plain version, so every reading is 0 and
    each control is far above the limit."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "BACKWARD_CASES", [
        ("causal", (1, 4, 2, 40, 40, 64, True, None)),
        ("cross", (2, 4, 4, 24, 37, 64, False, None)),
        ("window", (1, 2, 1, 30, 30, 256, True, 9))])
    devs = {}
    readings = chip_smoke.backward_checks(torch, ops, ref, "cpu", devs)
    assert len(readings) == 6
    assert devs["flash_attention_backward"] == {"float32": 0.0,
                                                "bfloat16": 0.0}
    assert min(r["control"] for r in readings) > 100 * \
        chip_smoke.BACKWARD_TOL_F32
    (bms, by), pairs = chip_smoke.backward_bound(
        (2, 40, 8, 4096, 4096, 128, True, None))
    assert pairs == 4096 * 4097 // 2 and by == "operations"
    assert abs(bms - 1e3 * 10 * 2 * 40 * pairs * 128 / 989e12) < 1e-9


# --------------------------------------------------------------------------
# The tensor-core instance of the backward kernel ("wgmma")
# --------------------------------------------------------------------------

def _emulate_tensor_core_backward(q, k, v, o, do, *, causal, window=None,
                                  terms=(2,)):
    """The tensor-core instance's rounding points (csrc/flash_backward.cu
    flash_attention_backward_tc), emulated: q, k, v, do exact bf16, every
    product accumulated in fp32; P, dP, delta and dS in fp32; P and dS
    split into ``t`` bf16 terms (each the rounding of what the earlier
    ones leave) before the three "P / dS x operand" products, each term
    its own product into one fp32 sum; each gradient rounded once to
    bf16.  Returns {t: (dq, dk, dv)} for each t of ``terms``."""
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = D ** -0.5
    f32 = torch.float32
    qf, dof = q.to(f32), do.to(f32)
    kr = k.to(f32).repeat_interleave(g, dim=1)
    vr = v.to(f32).repeat_interleave(g, dim=1)
    qi = torch.arange(S)[:, None]
    ki = torch.arange(Sk)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    probs = torch.softmax(torch.where(mask, qf @ kr.transpose(-1, -2) * scale,
                                      ref.NEG_INF), dim=-1)
    delta = (dof * o.to(f32)).sum(-1, keepdim=True)
    ds = probs * (dof @ vr.transpose(-1, -2) - delta)

    def split(x, t):
        parts = []
        for _ in range(t):
            part = x.to(torch.bfloat16).to(f32)
            parts.append(part)
            x = x - part
        return parts

    def group_sum(x):
        return x.reshape(B, KV, g, Sk, D).sum(dim=2)

    out = {}
    for t in terms:
        p_t, ds_t = split(probs, t), split(ds, t)
        dv = sum(p.transpose(-1, -2) @ dof for p in p_t)
        dq = sum(d @ kr for d in ds_t) * scale
        dk = sum(d.transpose(-1, -2) @ qf for d in ds_t) * scale
        out[t] = (dq.to(torch.bfloat16), group_sum(dk).to(torch.bfloat16),
                  group_sum(dv).to(torch.bfloat16))
    return out


# (B, H, KV, S, Sk, D, causal, window): qwen3-14b's head dim and group 5,
# causal at a ragged S; D = 64 under a window of 17; non-causal with keys
# of their own length
EMULATED = [
    (1, 10, 2, 997, 997, 128, True, None),
    (1, 8, 2, 300, 300, 64, True, 17),
    (2, 4, 4, 256, 300, 64, False, None),
]


@pytest.mark.parametrize("case", EMULATED)
def test_tensor_core_backward_numerics_need_two_terms(case):
    """chip_smoke.backward_deviation's bf16 limit (one bf16 ulp of the
    plain gradient plus 2e-5 of its max) holds for the emulated
    tensor-core instance with P and dS in two bf16 terms, and one term
    breaks it many times over: which is why the kernel splits them."""
    import chip_smoke
    B, H, KV, S, Sk, D, causal, window = case
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in (
        (B, H, S, D), (B, KV, Sk, D), (B, KV, Sk, D), (B, H, S, D)))
    o = ref.mha(q, k, v, causal=causal, window=window)
    want = ref.mha_backward(q, k, v, o, do, causal=causal, window=window)
    got = _emulate_tensor_core_backward(q, k, v, o, do, causal=causal,
                                        window=window, terms=(1, 2))
    shares = {t: [chip_smoke.backward_deviation(torch, g, w, "bfloat16")[2]
                  for g, w in zip(grads, want)]
              for t, grads in got.items()}
    assert max(shares[2]) <= 1.0
    assert min(shares[1]) > 4.0


@pytest.mark.parametrize("dtype,D,instance", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 32, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 256, "fma"),
])
def test_backward_instance_by_dtype_and_head_dim(dtype, D, instance):
    assert ops.flash_backward_instance(dtype, D) == instance
    assert ops.FLASH_BACKWARD_INSTANCES == ("wgmma", "fma")


def _backward_operands(D=128, dtype=torch.bfloat16):
    z = torch.zeros
    return {"q": z(1, 4, 8, D, dtype=dtype), "k": z(1, 2, 8, D, dtype=dtype),
            "v": z(1, 2, 8, D, dtype=dtype), "o": z(1, 4, 8, D, dtype=dtype),
            "do": z(1, 4, 8, D, dtype=dtype)}


@pytest.mark.parametrize("what", ["q", "k", "v", "o", "do"])
@pytest.mark.parametrize("fault", ["base", "stride"])
def test_misaligned_backward_operands_choose_the_fma_instance(what, fault):
    """Given q, k, v, o and do, a bf16 call at D = 128 with one operand's
    base 2 bytes off a 16-byte boundary, or its row pitch off 16 bytes,
    goes to the fp32-FMA instance, whose checks pass; forced by name, the
    tensor-core instance refuses it with ValueError before any launch."""
    ins = _backward_operands()
    assert ops.flash_backward_instance(torch.bfloat16, 128,
                                       *ins.values()) == "wgmma"
    ops._check_backward(*ins.values(), None, "wgmma", causal=True)
    shape = tuple(ins[what].shape)
    if fault == "base":
        ins[what] = torch.zeros(1 + ins[what].numel(),
                                dtype=torch.bfloat16)[1:].view(shape)
        assert ins[what].data_ptr() % 16 == 2
    else:
        ins[what] = torch.zeros(*shape[:3], 132,
                                dtype=torch.bfloat16)[..., :128]
    assert ops.flash_backward_instance(torch.bfloat16, 128,
                                       *ins.values()) == "fma"
    ops._check_backward(*ins.values(), None, "fma", causal=True)
    match = "16-byte aligned" if fault == "base" else "multiples of 16"
    with pytest.raises(ValueError, match=match):
        ops._check_backward(*ins.values(), None, "wgmma", causal=True)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 128),
                                     (torch.bfloat16, 96),
                                     (torch.float32, 64)])
def test_forced_tensor_core_backward_refuses_what_it_cannot_take(dtype, D):
    """fp32, and bf16 at a head dim other than 64, 128 and 256, have no
    tensor-core backward: forced by name, the check raises ValueError
    (before any launch); the default and the fp32-FMA instance take
    them."""
    ins = _backward_operands(D, dtype)
    with pytest.raises(ValueError, match="takes bf16"):
        ops._check_backward(*ins.values(), None, "wgmma", causal=True)
    ops._check_backward(*ins.values(), None, causal=True)
    ops._check_backward(*ins.values(), None, "fma", causal=True)
    with pytest.raises(ValueError, match="unknown instance"):
        ops._check_backward(*ins.values(), None, "tc", causal=True)


@pytest.mark.parametrize("fault", ["none", "base", "stride"])
def test_backward_at_head_dim_256_takes_the_tensor_core_instance(fault):
    """bf16 at D = 256 with aligned q, k, v, o, do takes the tensor-core
    backward, whose forced checks pass; do 2 bytes off a 16-byte boundary,
    or with a row pitch of 260 elements, sends the call to the fp32-FMA
    instance, and the tensor-core one forced by name refuses it."""
    ins = _backward_operands(256)
    if fault == "base":
        ins["do"] = torch.zeros(1 + ins["do"].numel(),
                                dtype=torch.bfloat16)[1:].view(1, 4, 8, 256)
    elif fault == "stride":
        ins["do"] = torch.zeros(1, 4, 8, 260, dtype=torch.bfloat16)[..., :256]
    want = "wgmma" if fault == "none" else "fma"
    assert ops.flash_backward_instance(torch.bfloat16, 256,
                                       *ins.values()) == want
    ops._check_backward(*ins.values(), 4, "fma", causal=True)
    if fault == "none":
        ops._check_backward(*ins.values(), 4, "wgmma", causal=True)
    else:
        with pytest.raises(ValueError, match="16"):
            ops._check_backward(*ins.values(), 4, "wgmma", causal=True)


def test_backward_scratch_by_instance():
    """The fp32-FMA instance keeps m, l and delta per row; the tensor-core
    one lse and delta per row of S rounded up to 128 rows (its 128-row
    query tiles at D = 64 and 128, two 64-row tiles at D = 256)."""
    assert ops.backward_stats_floats(2, 40, 4096, "fma") == 3 * 2 * 40 * 4096
    assert ops.backward_stats_floats(2, 40, 4096, "wgmma") == \
        2 * 2 * 40 * 4096
    assert ops.backward_stats_floats(1, 14, 999, "wgmma") == 2 * 14 * 1024
    # recurrentgemma-2b's long prompt: pass A writes rows up to 2112 (33
    # tiles of 64), within the 2176 rows of the scratch
    assert ops.backward_stats_floats(1, 10, 2099, "wgmma") == 2 * 10 * 2176
    # and where pass B splits the GQA group, the fp32 sums of dk and dv a
    # block: at D = 256 one query head a block
    assert ops.backward_splits(10, 1, 2099, 256, "wgmma") == 10
    assert ops.backward_partials_floats(1, 1, 10, 2099, 256) == \
        2 * 10 * 2099 * 256
    # qwen3-14b's (40/8, 4096, D = 128): a chain of 5 x 256 = 1,280 k16
    # steps, the whole group in one block, no partial sums
    assert ops.backward_splits(40, 8, 4096, 128, "wgmma") == 1
    assert ops.backward_partials_floats(2, 8, 1, 4096, 128) == 0
    assert ops.backward_splits(10, 1, 2099, 256, "fma") == 1


def test_chip_smoke_backward_instance_rehearsal(monkeypatch):
    """chip_smoke's phase 16 on CPU tensors at small shapes of its cases:
    every case (D = 64, 128 and 256: the tensor-core instance takes them
    all), both instance names running the plain version (every reading
    0), each control far above the limit, nothing timed; and its reader of
    the tensor-core kernels' build."""
    import types
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "BACKWARD_CASES", [
        ("causal", (1, 4, 2, 40, 40, 64, True, None)),
        ("cross", (2, 4, 4, 24, 37, 128, False, None)),
        ("window", (1, 2, 1, 30, 30, 256, True, 9))])
    devs = {}
    rows = chip_smoke.backward_instance_checks(torch, ops, ref, "cpu", devs)
    assert [r["case"] for r in rows] == ["causal", "cross", "window"]
    assert devs["flash_attention_backward"] == {"bfloat16": 0.0}
    for row in rows:
        for inst in ("wgmma", "fma"):
            assert row[inst]["dq"]["share"] == 0.0
            assert row[inst]["control"] > 100 * chip_smoke.BACKWARD_TOL_F32
            assert "ms" not in row[inst]

    names = [f"_ZN2tc{len(k)}{k}ILi{D}EEEv14CUtensorMap_stS1_S1_S1_NS_5Args"
             f"{'A' if k.startswith('dq') else 'B'}E"
             for k in chip_smoke.BACKWARD_TC_KERNELS
             for D in chip_smoke.FLASH_TC_HEAD_DIMS]
    log_text = "".join(
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        for fn in names)
    sass = "".join(
        f"\t\tFunction : {fn}\n"
        "        /*0100*/  UTMALDG.4D [UR8], [UR4] ;\n"
        "        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ ;\n"
        "        /*0210*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR9], R24 ;\n"
        "        /*0220*/  WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n"
        for fn in names)
    build = types.SimpleNamespace(build_log=lambda name: log_text)
    monkeypatch.setattr(chip_smoke, "disassemble", lambda b, name: sass)
    found = chip_smoke.backward_tensor_core_sass(build)
    assert set(found) == {f"{k}<{D}>" for k in ("dq_tc_kernel", "dkdv_tc_kernel")
                          for D in (64, 128, 256)}
    assert found["dkdv_tc_kernel<128>"]["HGMMA"] == 2
    assert found["dkdv_tc_kernel<128>"]["registers"] == 168
    spilled = log_text.replace("0 bytes spill stores", "708 bytes spill stores",
                               1)
    build = types.SimpleNamespace(build_log=lambda name: spilled)
    with pytest.raises(chip_smoke.SmokeFailure, match="spills"):
        chip_smoke.backward_tensor_core_sass(build)


def test_library_names_hash_the_shared_header(tmp_path, monkeypatch):
    """The tensor-core kernels include csrc/hopper.cuh: a library's name
    hashes every header under csrc/ beside its source, so an edited header
    builds a new library instead of loading a stale one."""
    from repro_torch.kernels import build
    assert (build.CSRC / "hopper.cuh").exists()
    src, header = tmp_path / "k.cu", tmp_path / "h.cuh"
    src.write_text("#include \"h.cuh\"\n")
    header.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setitem(build.SOURCES, "k", src)
    before = build.library_path("k")
    assert build.library_path("k") == before
    header.write_text("// two\n")
    assert build.library_path("k") != before


def test_delta_from_the_unrounded_output_where_keys_are_alike():
    """Where a layer's key inputs are alike (a common row plus a small
    spread, as the decoder of a deep random encoder-decoder gives them),
    a wk-like contraction x^T dk is nearly the exact zero sum of dS over
    the keys.  delta = rowsum(do * o) from the bf16 o carries an error
    common to every key of a row, which puts that contraction 15x its
    size off the fp32 autograd of the attention; delta from the unrounded
    o (what ``FlashAttention`` passes) keeps it at the floor of rounding
    the exact dk to bf16."""
    gen = torch.Generator().manual_seed(0)
    B, H, S, D = 1, 4, 512, 64

    def alike(spread):
        common = torch.randn((1, 1, 1, D), generator=gen)
        return common + spread * torch.randn((B, H, S, D), generator=gen)
    x = alike(0.02)
    q, k, v = (t.to(torch.bfloat16) for t in (alike(0.05), x, alike(0.05)))
    do = torch.randn((B, H, S, D), generator=gen).to(torch.bfloat16)
    ts = [t.float().requires_grad_() for t in (q, k, v)]
    full = ref.mha(*ts, causal=True)
    full.backward(do.float())
    exact = torch.einsum("bhsd,bhse->de", x, ts[1].grad)
    full = full.detach()

    def contraction_error(dk):
        got = torch.einsum("bhsd,bhse->de", x, dk.float())
        return float((got - exact).abs().max() / exact.abs().max())
    o = ref.mha(q, k, v, causal=True)
    rounded = contraction_error(ref.mha_backward(q, k, v, o, do)[1])
    delta = (do.float() * full).sum(-1)
    unrounded = contraction_error(
        ref.mha_backward(q, k, v, o, do, delta=delta)[1])
    floor = contraction_error(ts[1].grad.to(torch.bfloat16))
    assert unrounded <= 1.5 * floor
    assert rounded > 10 * floor
    ws = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ops.FlashAttention.apply(*ws, True, None, None).backward(do)
    assert torch.equal(ws[1].grad, ref.mha_backward(q, k, v, o, do,
                                                    delta=delta)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_group_of_16_matches_jax_autodiff_of_attend(dtype):
    """glm4-9b's GQA group of 16 (one kv head for 16 query heads), causal:
    ``ops.FlashAttention``'s gradients on CPU tensors against JAX's
    autodiff of its model's ``_attend`` on the same inputs (B, S, heads, D).
    fp32 within ATOL; bf16, where both sides round each gradient once from
    fp32 sums of the same terms in other orders, within one bf16 ulp of
    JAX's plus 1e-5 of its largest entry."""
    from repro.models import attention as jattention
    B, H, KV, S, D = 1, 16, 1, 40, 64
    rng = np.random.default_rng(16)
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pos = jnp.arange(S)
    _, vjp = jax.vjp(lambda a, b, c: jattention._attend(
        a, b, c, pos, pos, causal=True, window=None),
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    ts = [torch.tensor(a).to(tdt).transpose(1, 2).requires_grad_()
          for a in (q, k, v)]
    ops.FlashAttention.apply(*ts, True, None, None).backward(
        torch.tensor(do).to(tdt).transpose(1, 2))
    for t, w in zip(ts, want):
        got = t.grad.transpose(1, 2).float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert t.grad.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(got, w, atol=ATOL, rtol=0)
        else:
            limit = 2.0 ** -7 * np.abs(w) + 1e-5 * np.abs(w).max()
            assert (np.abs(got - w) <= limit).all()
