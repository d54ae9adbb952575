"""Torch port, flash attention on the CPU: the port's plain ``ref.mha`` and
``ops.flash_attention`` (which runs it for CPU tensors) against the JAX
package's Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it), its oracle ``ref.mha`` and the model's ``_attend``, on the cases of
``tests/test_kernels.py``; and the wrapper's operand checks.  The CUDA
kernel itself runs only on a card: ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import ops, ref
from repro_torch.models import attention
from _torch_cases import one_thread  # noqa: F401

# fp32: the same fp32 softmax summed in another order — the repo's kernel
# tier (tests/test_kernels.py).
ATOL = 2e-5
# bf16: both sides read the same bf16 inputs, compute in fp32 and round the
# output once, so they may differ by one bf16 ulp of the output.
BF16_ULP = 2.0 ** -7

# (B, H, KV, S, D, causal, window): tests/test_kernels.py:75-105
CASES = [
    (1, 2, 2, 128, 64, True, None), (2, 4, 2, 256, 64, True, None),
    (1, 4, 1, 128, 32, True, None), (1, 8, 2, 200, 64, True, None),
    (1, 14, 2, 128, 64, True, None), (1, 10, 1, 128, 128, True, None),
    (1, 4, 2, 160, 32, True, None), (1, 4, 2, 160, 32, False, None),
    (1, 4, 2, 160, 32, True, 64), (1, 4, 2, 160, 32, True, 17),
]


def _inputs(B, H, KV, S, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))


@pytest.mark.parametrize("case", CASES)
def test_plain_mha_and_cpu_wrapper_match_pallas_and_oracles(case):
    B, H, KV, S, D, causal, window = case
    q, k, v = _inputs(B, H, KV, S, D, seed=S + H + D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jops.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64))
    oracle = np.asarray(jref.mha(jq, jk, jv, causal=causal, window=window))
    pos = jnp.arange(S)
    attend = np.asarray(jattention._attend(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), pos, pos, causal=causal,
        window=window)).transpose(0, 2, 1, 3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = dict(ops.launches)
    got_ops = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert ops.launches == before          # the CPU runs the plain version
    got_mha = ref.mha(tq, tk, tv, causal=causal, window=window)
    tpos = torch.arange(S)
    got_attend = attention._attend(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), tpos,
        tpos, causal=causal, window=window).transpose(1, 2)
    for got in (got_ops, got_mha, got_attend):
        for want in (pallas, oracle, attend):
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_plain_mha_bf16_within_one_ulp_of_pallas():
    """bf16 q, k, v (tests/test_kernels.py's bf16 case): the port's plain
    version and the Pallas kernel round the fp32 output once, so they agree
    to one bf16 ulp.  (The JAX oracle takes a bf16-rounded 1/sqrt(D) and is
    held to 2e-2 there; the port follows the kernel's fp32 scale.)"""
    q, k, v = _inputs(1, 4, 2, 128, 64, seed=5)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    pallas = np.asarray(jops.flash_attention(*bf), np.float32)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - pallas) <= BF16_ULP * np.abs(pallas) + 1e-6)


def test_self_attend_on_cpu_is_the_plain_attend():
    """The model's self-attention on CPU tensors is ``_attend`` over
    positions 0..S-1, bit for bit, with no kernel launch."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 37, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 37, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 37, 2, 16)).astype(np.float32))
    before = dict(ops.launches)
    got = attention.self_attend(q, k, v, causal=True, window=9)
    pos = torch.arange(37)
    want = attention._attend(q, k, v, pos, pos, causal=True, window=9)
    assert torch.equal(got, want) and ops.launches == before


@pytest.mark.parametrize("what,make,err", [
    ("dtype", lambda q, k, v: (q, k.double(), v), TypeError),
    ("fp16", lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    ("group", lambda q, k, v: (q[:, :3], k, v), ValueError),
    ("head dim", lambda q, k, v: (torch.zeros(1, 4, 8, 264),
                                  torch.zeros(1, 2, 8, 264),
                                  torch.zeros(1, 2, 8, 264)), ValueError),
    ("kv shape", lambda q, k, v: (q, k[:, :, :5], v), ValueError),
    ("stride", lambda q, k, v: (q.transpose(2, 3), k, v), ValueError),
])
def test_wrapper_checks_raise_before_launch(what, make, err):
    """The operand checks the wrapper runs before a launch on the card,
    exercised on CPU tensors."""
    q, k, v = (torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16),
               torch.zeros(1, 2, 8, 16))
    with pytest.raises(err):
        ops._check_attention(*make(q, k, v), None, causal=True)


def test_wrapper_checks_window_and_accept_strided_views():
    q = torch.zeros(1, 8, 4, 16).transpose(1, 2)      # (B, H, S, D) view
    k = torch.zeros(1, 8, 2, 16).transpose(1, 2)
    ops._check_attention(q, k, k, 3, causal=True)
    with pytest.raises(ValueError):
        ops._check_attention(q, k, k, 0, causal=True)
    # the output buffer takes q's strides, so it transposes back for free
    assert torch.empty_like(q).transpose(1, 2).is_contiguous()


# --------------------------------------------------------------------------
# The tensor-core instance (bf16, D = 64 or 128): its numerics and its rules
# --------------------------------------------------------------------------

def _emulate_tensor_core_instance(q, k, v, *, causal, window=None, terms=3,
                                  tile=64):
    """Plain torch at the rounding points of ``flash_tc_kernel``
    (csrc/flash_attention.cu): 64-key tiles, an online softmax in fp32 in
    log2 units, P = 2^(s - m) split into ``terms`` bf16 terms (each the
    rounding of what the earlier ones leave) whose products with the bf16
    V are summed in fp32, one rounding of the output to bf16."""
    B, H, S, D = q.shape
    g = H // k.shape[1]
    f32 = torch.float32
    qf = q.to(f32)
    kf = k.to(f32).repeat_interleave(g, 1)
    vf = v.to(f32).repeat_interleave(g, 1)
    scale_log2 = D ** -0.5 * 1.4426950408889634
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    qi = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        ki = torch.arange(k0, min(k0 + tile, S))[None, :]
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) * scale_log2
        ok = torch.ones(S, ki.shape[1], dtype=torch.bool)
        if causal:
            ok &= ki <= qi
        if window is not None:
            ok &= ki > qi - window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for _ in range(terms):
            part = p.to(torch.bfloat16).to(f32)
            acc = acc + part @ vf[:, :, k0:k0 + tile]
            p = p - part
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


def _bf16_inputs(B, H, KV, S, D, seed):
    return tuple(torch.from_numpy(a).to(torch.bfloat16)
                 for a in _inputs(B, H, KV, S, D, seed))


def test_tensor_core_numerics_hold_the_one_ulp_limit():
    """The tensor-core instance's rounding points, emulated, against the
    plain version under the card's limit (chip_smoke.flash_deviation: one
    bf16 ulp of the plain output plus 1e-6), at qwen3-14b's head dim, GQA
    group 5, causal, a ragged S.  P rounded once to bf16 before P.V breaks
    the limit there, which is why the kernel splits P."""
    import chip_smoke
    q, k, v = _bf16_inputs(1, 10, 2, 997, 128, seed=0)
    want = ref.mha(q, k, v, causal=True)
    got = _emulate_tensor_core_instance(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    assert chip_smoke.flash_deviation(torch, got, want, "bfloat16")[1] <= 1.0
    once = _emulate_tensor_core_instance(q, k, v, causal=True, terms=1)
    assert chip_smoke.flash_deviation(torch, once, want, "bfloat16")[1] > 1.0


def test_tensor_core_numerics_need_three_terms_of_p():
    """Rows that see few keys (a window of 17) have small outputs, where
    the limit's 1e-6 floor binds: P split into two bf16 terms (p to about
    2^-17) misses it, three terms (all 24 bits of p) hold it."""
    import chip_smoke
    q, k, v = _bf16_inputs(1, 8, 2, 300, 128, seed=1)
    want = ref.mha(q, k, v, causal=True, window=17)
    shares = {terms: chip_smoke.flash_deviation(
        torch, _emulate_tensor_core_instance(q, k, v, causal=True, window=17,
                                             terms=terms),
        want, "bfloat16")[1] for terms in (2, 3)}
    assert shares[2] > 1.0 >= shares[3]


@pytest.mark.parametrize("dtype,D,instance", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 96, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 256, "fma"),
])
def test_flash_instance_is_chosen_by_dtype_and_head_dim(dtype, D, instance):
    assert ops.flash_instance(dtype, D) == instance


def _bf16_zeros(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("what", ["q", "k", "v"])
def test_tensor_core_instance_rejects_a_misaligned_base(what):
    """A base 2 bytes past a 16-byte boundary (strides fine) raises
    ValueError before any launch; the same tensor in fp32 takes the FMA
    instance, which has no such rule."""
    ops_in = {"q": _bf16_zeros(1, 4, 8, 128), "k": _bf16_zeros(1, 2, 8, 128),
              "v": _bf16_zeros(1, 2, 8, 128)}
    shape = tuple(ops_in[what].shape)
    flat = _bf16_zeros(1 + ops_in[what].numel())
    ops_in[what] = flat[1:].view(shape)
    assert ops_in[what].data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check_attention(ops_in["q"], ops_in["k"], ops_in["v"], None,
                             causal=True)
    ops._check_attention(*(t.float() for t in ops_in.values()), None,
                         causal=True)


@pytest.mark.parametrize("row", [132, 68])
def test_tensor_core_instance_rejects_strides_off_16_bytes(row):
    """A row pitch of 132 (D = 128) or 68 (D = 64) bf16 elements is not a
    multiple of 16 bytes: ValueError before any launch."""
    D = row - 4
    q = _bf16_zeros(1, 4, 8, row)[..., :D]
    k = _bf16_zeros(1, 2, 8, D)
    assert ops.flash_instance(q.dtype, D) == "wgmma"
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ops._check_attention(q, k, k, None, causal=True)


def test_tensor_core_instance_takes_the_models_transposed_views():
    """The model's (B, S, H, D) projections go in as .transpose(1, 2);
    a batch of 1 or one head leaves a size-1 dimension whose stride is
    never stepped over, and the tensor map gets the tensor's span there."""
    for B, heads in ((2, 40), (1, 40), (1, 1)):
        q = _bf16_zeros(B, 100, heads, 128).transpose(1, 2)
        k = _bf16_zeros(B, 100, 1 if heads == 1 else 8, 128).transpose(1, 2)
        ops._check_attention(q, k, k, 64, causal=True)
        strides = ops._tma_strides(q)
        assert all(st > 0 and st % 8 == 0 for st in strides)
        assert strides[2] == heads * 128
    odd = _bf16_zeros(3, 1, 5, 64)
    assert ops._tma_strides(odd) == [320, 960, 64]   # the span, 3 x 320


@pytest.mark.parametrize("what", ["q", "k", "v"])
@pytest.mark.parametrize("fault", ["base", "stride"])
def test_misaligned_bf16_operands_choose_the_fma_instance(what, fault):
    """Given the operands, ``flash_instance`` sends a bf16 call at D = 128
    whose base is 2 bytes off a 16-byte boundary, or whose row pitch is not
    a multiple of 16 bytes, to the fp32-FMA instance, whose checks pass;
    the tensor-core instance still refuses the operands when asked for by
    name, and takes the aligned ones."""
    ops_in = {"q": _bf16_zeros(1, 4, 8, 128), "k": _bf16_zeros(1, 2, 8, 128),
              "v": _bf16_zeros(1, 2, 8, 128)}
    assert ops.flash_instance(torch.bfloat16, 128,
                              *ops_in.values()) == "wgmma"
    ops._check_attention(*ops_in.values(), None, "wgmma", causal=True)
    shape = tuple(ops_in[what].shape)
    if fault == "base":
        ops_in[what] = _bf16_zeros(1 + ops_in[what].numel())[1:].view(shape)
    else:
        ops_in[what] = _bf16_zeros(*shape[:3], 132)[..., :128]
    assert ops.flash_instance(torch.bfloat16, 128, *ops_in.values()) == "fma"
    ops._check_attention(*ops_in.values(), None, "fma", causal=True)
    with pytest.raises(ValueError, match="16"):
        ops._check_attention(*ops_in.values(), None, "wgmma", causal=True)
    fp32 = [t.float() for t in ops_in.values()]
    with pytest.raises(ValueError, match="takes bf16"):
        ops._check_attention(*fp32, None, "wgmma", causal=True)
    with pytest.raises(ValueError, match="unknown instance"):
        ops._check_attention(*fp32, None, "tc", causal=True)


@pytest.mark.parametrize("fault", ["base", "stride"])
def test_misaligned_bf16_at_head_dim_256_chooses_the_fma_instance(fault):
    """At D = 256 as at 64 and 128: aligned bf16 operands take the
    tensor-core instance; q 2 bytes off a 16-byte boundary, or with a row
    pitch of 260 elements, goes to the fp32-FMA instance, whose checks
    pass, and the tensor-core instance forced by name refuses it."""
    ops_in = {"q": _bf16_zeros(1, 10, 8, 256), "k": _bf16_zeros(1, 1, 8, 256),
              "v": _bf16_zeros(1, 1, 8, 256)}
    assert ops.flash_instance(torch.bfloat16, 256,
                              *ops_in.values()) == "wgmma"
    ops._check_attention(*ops_in.values(), 4, "wgmma", causal=True)
    if fault == "base":
        ops_in["q"] = _bf16_zeros(1 + ops_in["q"].numel())[1:].view(
            1, 10, 8, 256)
    else:
        ops_in["q"] = _bf16_zeros(1, 10, 8, 260)[..., :256]
    assert ops.flash_instance(torch.bfloat16, 256, *ops_in.values()) == "fma"
    ops._check_attention(*ops_in.values(), 4, "fma", causal=True)
    with pytest.raises(ValueError, match="16"):
        ops._check_attention(*ops_in.values(), 4, "wgmma", causal=True)


def test_chip_smoke_forward_instance_rehearsal(monkeypatch):
    """chip_smoke's phase 16, the forward, on CPU tensors at small shapes
    of its cases (D = 64, 128 and 256, a window, keys of their own
    length): both instance names run the plain version (every reading 0),
    nothing timed."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "BACKWARD_CASES", [
        ("causal", (1, 4, 2, 40, 40, 64, True, None)),
        ("cross", (2, 4, 4, 24, 37, 128, False, None)),
        ("window", (1, 2, 1, 30, 30, 256, True, 9))])
    devs = {}
    rows = chip_smoke.forward_instance_checks(torch, ops, ref, "cpu", devs)
    assert [r["case"] for r in rows] == ["causal", "cross", "window"]
    assert devs["flash_attention"] == {"bfloat16": 0.0}
    for row in rows:
        for inst in ops.FLASH_INSTANCES:
            assert row[inst] == {"max_abs_dev": 0.0, "share": 0.0}


def test_chip_smoke_tensor_core_build_reader_needs_every_head_dim(
        monkeypatch):
    """chip_smoke's build check of the forward's tensor-core instance: the
    three instantiations (D = 64, 128, 256) must each issue wgmma and TMA
    loads and spill nothing; a missing D = 256, a spill, or no HGMMA fails
    the run."""
    import types
    import chip_smoke

    def entry(D):
        return (f"_ZN2tc15flash_tc_kernelILi{D}EEEv14CUtensorMap_stS1_S1_NS_"
                "7OutArgsEiiifii")

    def build_with(dims, spill=0, hgmma=2):
        log_text = "".join(
            f"ptxas info    : Compiling entry function '{entry(D)}' for "
            f"'sm_90a'\n    0 bytes stack frame, {spill} bytes spill "
            "stores, 0 bytes spill loads\nptxas info    : Used 250 "
            "registers, used 1 barriers\n" for D in dims)
        sass = "".join(
            f"\t\tFunction : {entry(D)}\n        /*0100*/  UTMALDG.4D [UR8],"
            " [UR4] ;\n" + "        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, "
            "gdesc[UR8], RZ ;\n" * hgmma for D in dims)
        monkeypatch.setattr(chip_smoke, "disassemble", lambda b, name: sass)
        return types.SimpleNamespace(build_log=lambda name: log_text)

    found = chip_smoke.tensor_core_sass(build_with((64, 128, 256)))
    assert found == {64: (2, 1), 128: (2, 1), 256: (2, 1)}
    for kw, match in ((dict(dims=(64, 128)), "no wgmma"),
                      (dict(dims=(64, 128, 256), spill=708), "spills"),
                      (dict(dims=(64, 128, 256), hgmma=0), "no wgmma")):
        with pytest.raises(chip_smoke.SmokeFailure, match=match):
            chip_smoke.tensor_core_sass(build_with(**kw))


def test_chip_smoke_reads_the_tensor_core_build():
    """chip_smoke.py's readers of the tensor-core instance: the ptxas line
    of flash_tc_kernel<128> and cuobjdump's HGMMA / UTMALDG counts."""
    import chip_smoke
    assert chip_smoke.ptxas_report(
        "ptxas info    : Compiling entry function '_ZN2tc15flash_tc_kernelI"
        "Li128EEEv14CUtensorMap_stS1_S1_NS_7OutArgsEiiifii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n") == [
        ("flash_tc_kernel<128>", 168,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
    sass = ("\t\tFunction : _ZN2tc15flash_tc_kernelILi64EEEv14CUtensorMap\n"
            "        /*0100*/  UTMALDG.4D [UR8], [UR4] ;\n"
            "        /*0200*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ ;\n"
            "        /*0210*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;\n"
            "\t\tFunction : _ZN12_GLOBAL__N_112flash_kernelIfLi32EEEv\n"
            "        /*0100*/  FFMA R1, R2, R3, R1 ;\n")
    assert chip_smoke.sass_counts(sass) == {
        "_ZN2tc15flash_tc_kernelILi64EEEv14CUtensorMap": (2, 1),
        "_ZN12_GLOBAL__N_112flash_kernelIfLi32EEEv": (0, 0)}
