"""Torch port, the Mamba-2 mixer on the CPU: the plain SSD scans
(``ssd_chunked`` with and without an initial state, ``ssd_naive``, and the
``ssd_scan`` kernel's plain version, ragged tails included), the causal
conv, the full-sequence mixer, the one-token decode and the weight
carrier, each against the JAX package on the same numpy inputs and
JAX-initialised weights (the reduced mamba2-370m, fp32); and the
``ssd_scan`` wrapper's operand checks.  The CUDA kernel itself runs only
on a card: ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.models import convert, ssm
from _torch_cases import one_thread  # noqa: F401

# fp32: the same fp32 arithmetic summed in another order — the repo's SSD
# tier (tests/test_kernels.py:120, tests/test_prefill.py).
ATOL = 5e-5
KEY = jax.random.PRNGKey(0)
ARCH = "mamba2_370m"

# (b, s, h, p, n, chunk): tests/test_kernels.py:105-108
KERNEL_CASES = [
    (1, 64, 2, 8, 16, 32), (2, 128, 3, 16, 32, 64),
    (1, 96, 4, 32, 128, 32), (1, 128, 1, 8, 16, 128),
]


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port model) on the same
    weights: the reduced mamba2-370m."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jp = jmodel.init_params(jcfg, KEY)
    return jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=atol, rtol=0)


def _scan_inputs(b, s, h, p, n, seed):
    """As tests/test_kernels.py draws them: standard normal x, B, C;
    dt = |N| 0.1 + 0.01; A = -(|N| + 0.5); D = |N|."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(f32),
        dt=(np.abs(rng.standard_normal((b, s, h))) * 0.1 + 0.01).astype(f32),
        A=-(np.abs(rng.standard_normal(h)) + 0.5).astype(f32),
        B=rng.standard_normal((b, s, n)).astype(f32),
        C=rng.standard_normal((b, s, n)).astype(f32),
        D=np.abs(rng.standard_normal(h)).astype(f32),
        s0=rng.standard_normal((b, h, p, n)).astype(f32))


def _args(d, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(d[k]) for k in ("x", "dt", "A", "B", "C")]


@pytest.mark.parametrize("chunk", [8, 16, 32, 96])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_and_naive_match_jax(chunk, with_state):
    """tests/test_models.py::test_ssd_chunked_vs_naive's inputs: y and the
    final state of both scans, with and without an initial state."""
    d = _scan_inputs(2, 96, 4, 8, 16, seed=0)
    jx, tx = _args(d, "jax"), _args(d, "torch")
    js0 = jnp.asarray(d["s0"]) if with_state else None
    ts0 = torch.from_numpy(d["s0"]) if with_state else None
    jD, tD = jnp.asarray(d["D"]), torch.from_numpy(d["D"])
    jy, jf = jssm.ssd_chunked(*jx, chunk, D=jD, init_state=js0)
    ty, tf = ssm.ssd_chunked(*tx, chunk, D=tD, init_state=ts0)
    _close(ty, jy)
    _close(tf, jf)
    ny, nf = jssm.ssd_naive(*jx, D=jD, init_state=js0)
    ty, tf = ssm.ssd_naive(*tx, D=tD, init_state=ts0)
    _close(ty, ny)
    _close(tf, nf)


def test_ssd_chunked_refuses_a_ragged_chunk():
    d = _scan_inputs(1, 20, 1, 4, 8, seed=1)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(*_args(d, "torch"), 8)


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_plain_ssd_scan_matches_pallas_and_naive(case):
    """The kernel's plain version (and the wrapper, which runs it for CPU
    tensors, with no launch) against the Pallas kernel in interpret mode
    (y) and the JAX oracle ``ssd_naive`` (y and the final state, which the
    Pallas kernel does not return)."""
    b, s, h, p, n, chunk = case
    d = _scan_inputs(b, s, h, p, n, seed=s + h + n)
    jx, tx = _args(d, "jax"), _args(d, "torch")
    jD, tD = jnp.asarray(d["D"]), torch.from_numpy(d["D"])
    pallas = jops.ssd_scan(*jx, jD, chunk=chunk)
    ny, nf = jssm.ssd_naive(*jx, D=jD)
    before = dict(ops.launches)
    got_ops = ops.ssd_scan(*tx, tD, chunk=chunk)
    assert ops.launches == before          # the CPU runs the plain version
    got_ref = ref.ssd_scan(*tx, tD, chunk=chunk)
    for y, f in (got_ops, got_ref):
        assert y.dtype == torch.float32 and f.shape == (b, h, p, n)
        _close(y, pallas)
        _close(y, ny)
        _close(f, nf)


@pytest.mark.parametrize("s,chunk", [(97, 16), (63, 64), (130, 32), (5, 8)])
def test_plain_ssd_scan_ragged_tail_matches_jax(s, chunk):
    """A ragged s, padded with dt = 0 inside the plain scan, against JAX's
    ``ssd_chunked`` at the model's shrunken chunk (97 is prime: chunk 1),
    for y and the final state."""
    d = _scan_inputs(2, s, 3, 8, 16, seed=s)
    jx, tx = _args(d, "jax"), _args(d, "torch")
    jD, tD = jnp.asarray(d["D"]), torch.from_numpy(d["D"])
    jchunk = ssm.jax_chunk(chunk, s)
    assert s % chunk == 0 or jchunk < chunk
    jy, jf = jssm.ssd_chunked(*jx, jchunk, D=jD)
    ty, tf = ref.ssd_scan(*tx, tD, chunk=chunk)
    assert ty.shape == (2, s, 3, 8)
    _close(ty, jy)
    _close(tf, jf)


def test_plain_ssd_scan_where_exp_cum_underflows():
    """A*dt = -32 a row: over a 64-row chunk cum reaches -2048 and exp(cum)
    is 0 in fp32.  The decays are formed from differences of cum, so the
    scan stays finite and matches the direct recurrence (a ratio of
    exp(cum) would give 0/0)."""
    d = _scan_inputs(1, 150, 2, 8, 16, seed=7)
    d["A"] = np.array([-16.0, -1.0], np.float32)
    d["dt"] = np.full_like(d["dt"], 2.0)
    jx, tx = _args(d, "jax"), _args(d, "torch")
    jD, tD = jnp.asarray(d["D"]), torch.from_numpy(d["D"])
    ty, tf = ref.ssd_scan(*tx, tD, chunk=64)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(tf).all())
    ny, nf = jssm.ssd_naive(*jx, D=jD)
    _close(ty, ny)
    _close(tf, nf)


def test_plain_ssd_scan_bf16_rounds_y_once():
    """bf16 x, B, C: the plain version widens them exactly, computes in
    fp32 and rounds y once, so it equals the fp32 scan of the widened
    inputs rounded to bf16; the state stays fp32."""
    d = _scan_inputs(1, 40, 2, 8, 16, seed=3)
    x, dt, A, B, C = _args(d, "torch")
    D = torch.from_numpy(d["D"])
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, B, C))
    y, f = ref.ssd_scan(xb, dt, A, Bb, Cb, D, chunk=16)
    wy, wf = ref.ssd_scan(xb.float(), dt, A, Bb.float(), Cb.float(), D,
                          chunk=16)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    assert torch.equal(y, wy.to(torch.bfloat16))
    assert torch.equal(f, wf)


def test_causal_conv_and_split_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(4)
    conv_ch = jcfg.ssm_dinner + 2 * jcfg.ssm_state
    for S in (1, 2, 9):       # shorter than, and past, the conv width
        u = rng.standard_normal((2, S, conv_ch)).astype(np.float32)
        w = rng.standard_normal((jcfg.conv_width, conv_ch)).astype(np.float32)
        bias = rng.standard_normal(conv_ch).astype(np.float32)
        _close(ssm._causal_conv(*map(torch.from_numpy, (u, w, bias))),
               jssm._causal_conv(*map(jnp.asarray, (u, w, bias))))
    z = rng.standard_normal((2, 3, tp.layers[0].mixer.in_proj.shape[1])
                            ).astype(np.float32)
    for got, want in zip(ssm._split_proj(torch.from_numpy(z), tcfg),
                         jssm._split_proj(jnp.asarray(z), jcfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", [1, 16, 23, 32])
def test_mamba_forward_matches_jax(pair, S):
    """The mixer at whole, ragged (23 is prime) and one-token lengths; on
    the CPU it runs the plain ``ssd_chunked`` at JAX's chunk."""
    jcfg, jp, tcfg, tp = pair
    jm = jax.tree.map(lambda t: t[0], jp["layers"])["mixer"]
    u = np.random.default_rng(S).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    before = dict(ops.launches)
    got = ssm.mamba_forward(tp.layers[0].mixer, torch.from_numpy(u), tcfg)
    assert ops.launches == before
    _close(got, jssm.mamba_forward(jm, jnp.asarray(u), jcfg))


def test_mamba_decode_matches_jax(pair):
    """Token-by-token decode of one mixer from a seeded cache: the output
    and both cache entries after every step; the port updates its cache
    in place."""
    jcfg, jp, tcfg, tp = pair
    jm = jax.tree.map(lambda t: t[0], jp["layers"])["mixer"]
    tm = tp.layers[0].mixer
    B, steps = 2, 6
    rng = np.random.default_rng(5)
    jc = jssm.init_mamba_cache(jcfg, B, jnp.float32)
    jc = {name: jnp.asarray(rng.standard_normal(t.shape).astype(np.float32)
                            * 0.3) for name, t in jc.items()}
    tc = {name: convert.to_tensor(t, "cpu") for name, t in jc.items()}
    assert set(tc) == set(ssm.init_mamba_cache(tcfg, B, torch.float32,
                                               "cpu"))
    xs = rng.standard_normal((steps, B, 1, jcfg.d_model)).astype(np.float32)
    for t in range(steps):
        jo, jc = jssm.mamba_decode(jm, jnp.asarray(xs[t]), jc, jcfg)
        views = dict(tc)
        to, out_cache = ssm.mamba_decode(tm, torch.from_numpy(xs[t]), views,
                                         tcfg)
        assert out_cache["ssm"] is tc["ssm"]      # updated in place
        _close(to, jo)
        for name in jc:
            _close(tc[name], jc[name])


def test_init_mamba_cache_layout(pair):
    jcfg, _, tcfg, _ = pair
    jc = jssm.init_mamba_cache(jcfg, 3, jnp.bfloat16)
    tc = ssm.init_mamba_cache(tcfg, 3, torch.bfloat16, "cpu")
    for name, t in jc.items():
        assert tuple(tc[name].shape) == t.shape
        assert convert.to_numpy(tc[name]).dtype == np.float32
        assert (tc[name].dtype == torch.float32) == (t.dtype == jnp.float32)
        assert not tc[name].any()


def test_params_from_jax_takes_the_whole_mamba_tree():
    """Every leaf of the bf16 JAX mamba2 tree lands in the port: A_log, D
    and dt_bias stay fp32 in a bf16 model, and the SSM block's unused ln2
    has its counterpart; a leaf cast to bf16 is refused."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_reduced(ARCH),
                               param_dtype="bfloat16")
    jp = jmodel.init_params(jcfg, KEY)
    tp = convert.params_from_jax(jp, tcfg, "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(tp.named_parameters())
    assert len(named) == sum(jcfg.num_layers if path[0].key == "layers"
                             else 1 for path, _ in leaves)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[0] != "layers":
            np.testing.assert_array_equal(
                convert.to_numpy(named[".".join(keys)]),
                np.asarray(leaf, np.float32))
            continue
        for i in range(jcfg.num_layers):
            got = named[".".join(["layers", str(i)] + keys[1:])]
            np.testing.assert_array_equal(convert.to_numpy(got),
                                          np.asarray(leaf[i], np.float32))
    mixer = tp.layers[1].mixer
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(mixer, name).dtype == torch.float32
    assert mixer.in_proj.dtype == torch.bfloat16
    assert hasattr(tp.layers[0], "ln2")
    bad = jax.tree.map(lambda t: t, jp)
    bad["layers"]["mixer"]["A_log"] = bad["layers"]["mixer"]["A_log"].astype(
        jnp.bfloat16)
    with pytest.raises(ValueError, match="A_log"):
        convert.params_from_jax(bad, tcfg, "cpu")


def test_model_ssd_on_cpu_is_ssd_chunked_at_jax_chunk(pair):
    """``ssm.ssd`` on CPU tensors: ``ssd_chunked`` at the chunk JAX picks,
    bit for bit, with no launch."""
    _, _, tcfg, _ = pair
    d = _scan_inputs(1, 46, 2, 8, tcfg.ssm_state, seed=6)
    tx = _args(d, "torch")
    D = torch.from_numpy(d["D"])
    before = dict(ops.launches)
    y, f = ssm.ssd(*tx, D, tcfg)
    wy, wf = ssm.ssd_chunked(*tx, ssm.jax_chunk(tcfg.ssm_chunk, 46), D=D)
    assert ssm.jax_chunk(tcfg.ssm_chunk, 46) == 2
    assert torch.equal(y, wy) and torch.equal(f, wf)
    assert ops.launches == before


def _strided_case():
    """x, B, C as the model hands them in: column slices of one conv
    output."""
    buf = torch.zeros(1, 70, 4 * 16 + 2 * 32)
    x = buf[..., :64].reshape(1, 70, 4, 16)
    return dict(x=x, dt=torch.zeros(1, 70, 4), A=torch.zeros(4),
                B=buf[..., 64:96], C=buf[..., 96:], D=torch.zeros(4))


@pytest.mark.parametrize("what,change,err", [
    ("x dtype", dict(x=lambda t: t.double()), TypeError),
    ("fp16", dict(x=lambda t: t.half(), B=lambda t: t.half(),
                  C=lambda t: t.half()), TypeError),
    ("B dtype", dict(B=lambda t: t.to(torch.bfloat16)), TypeError),
    ("dt dtype", dict(dt=lambda t: t.to(torch.bfloat16)), TypeError),
    ("dt shape", dict(dt=lambda t: t[:, :, :3]), ValueError),
    ("A shape", dict(A=lambda t: t[:3]), ValueError),
    ("C shape", dict(C=lambda t: t[:, :60]), ValueError),
    ("x stride", dict(x=lambda t: t.transpose(2, 3)), ValueError),
    ("B stride", dict(B=lambda t: t[..., ::2]), ValueError),
    ("n % 4", dict(B=lambda t: t[..., :30], C=lambda t: t[..., :30]),
     ValueError),
])
def test_ssd_wrapper_checks_raise_before_launch(what, change, err):
    """The operand checks the wrapper runs before a launch on the card,
    exercised on CPU tensors; the model's strided slices pass."""
    case = _strided_case()
    ops._check_ssd(*case.values(), 64)
    for name, fn in change.items():
        case[name] = fn(case[name])
    with pytest.raises(err):
        ops._check_ssd(*case.values(), 64)


@pytest.mark.parametrize("chunk,n,ok", [
    (64, 128, True), (32, 128, True), (128, 16, True), (128, 128, False),
    (4, 16, False), (60, 16, False), (256, 16, False)])
def test_ssd_wrapper_checks_chunk_and_shared_memory(chunk, n, ok):
    """Chunks are multiples of 8 up to 128 whose block fits the card's
    227 KB of shared memory; mamba2-370m's (64, 128) takes 143,360 bytes."""
    case = _strided_case()
    case["B"] = case["C"] = torch.zeros(1, 70, n)
    assert ops.ssd_smem_bytes(64, 128) == 143360
    if ok:
        ops._check_ssd(*case.values(), chunk)
    else:
        with pytest.raises(ValueError, match="chunk"):
            ops._check_ssd(*case.values(), chunk)
