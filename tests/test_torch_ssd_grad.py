"""Torch port, the gradient of the SSD scan on the CPU: the plain version
of the ``ssd_scan_backward`` kernel (``ref.ssd_scan_backward``, the closed
form the kernel computes) against ``jax.vjp`` of the JAX package's
``repro.models.ssm.ssd_chunked`` with cotangents for y and the final
state (ragged tails, where the port pads and JAX shrinks its chunk; an
underflowing exp(cum); bf16 inputs), ``ops.SSDScan`` under
``torch.autograd`` against autograd of the port's ``ssd_chunked`` on the
model's strided slices, the backward wrapper's operand checks, and the
reduced mamba2's ``loss_fn`` gradients with ``models.ssm.ssd`` routed
through ``ops.SSDScan`` against JAX's.  The CUDA kernel itself runs only
on a card: ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import model as jmodel
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.models import convert, model, ssm
from _torch_cases import one_thread  # noqa: F401

# fp32 on both sides, summed in other orders: each gradient within this
# share of its largest entry (the acceptance limit; measured at most
# ~1e-6 on these cases)
REL = 1e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
# (b, s, h, p, n, chunk): tests/test_kernels.py's shapes, then ragged
# tails (97 is prime: JAX's chunk shrinks to 1) and several chunks
CASES = [
    (1, 64, 2, 8, 16, 32), (2, 128, 3, 16, 32, 64), (1, 96, 4, 32, 128, 32),
    (2, 97, 3, 8, 16, 16), (1, 130, 2, 16, 32, 32), (1, 63, 2, 8, 16, 64),
]


def _inputs(b, s, h, p, n, seed):
    """As tests/test_kernels.py draws the scan's inputs (standard normal x,
    B, C; dt = |N| 0.1 + 0.01; A = -(|N| + 0.5); D = |N|), and standard
    normal cotangents of y and of the final state."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(f32),
        dt=(np.abs(rng.standard_normal((b, s, h))) * 0.1 + 0.01).astype(f32),
        A=-(np.abs(rng.standard_normal(h)) + 0.5).astype(f32),
        B=rng.standard_normal((b, s, n)).astype(f32),
        C=rng.standard_normal((b, s, n)).astype(f32),
        D=np.abs(rng.standard_normal(h)).astype(f32),
        dy=rng.standard_normal((b, s, h, p)).astype(f32),
        dfinal=rng.standard_normal((b, h, p, n)).astype(f32))


def _jax_vjp(d, chunk, dfinal=True):
    """The six gradients of JAX's ``ssd_chunked`` at the model's chunk
    (the largest <= chunk that divides s)."""
    s = d["x"].shape[1]
    jchunk = ssm.jax_chunk(chunk, s)
    args = [jnp.asarray(d[k]) for k in ("x", "dt", "A", "B", "C", "D")]
    _, vjp = jax.vjp(lambda x, dt, A, B, C, D: jssm.ssd_chunked(
        x, dt, A, B, C, jchunk, D=D), *args)
    df = (jnp.asarray(d["dfinal"]) if dfinal
          else jnp.zeros_like(jnp.asarray(d["dfinal"])))
    return [np.asarray(g) for g in vjp((jnp.asarray(d["dy"]), df))]


def _port(d, chunk, dfinal=True):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return ref.ssd_scan_backward(
        t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], t["dy"],
        t["dfinal"] if dfinal else None, chunk=chunk)


def _assert_rel(got, want, rel=REL):
    for name, g, w in zip(NAMES, got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1e-30)
        dev = np.abs(g - w).max()
        assert dev <= rel * scale, (name, dev / scale)


@pytest.mark.parametrize("dfinal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case, dfinal):
    """Each of the six gradients within 1e-5 of its max |grad| of
    ``jax.vjp`` of ``ssd_chunked``, with a cotangent for the final state
    or none; a ragged s pads here and shrinks JAX's chunk."""
    b, s, h, p, n, chunk = case
    d = _inputs(b, s, h, p, n, seed=CASES.index(case))
    got = _port(d, chunk, dfinal)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_rel(got, _jax_vjp(d, chunk, dfinal))


def test_plain_backward_where_exp_cum_underflows():
    """A*dt = -32 a row: over a 64-row chunk cum reaches -2048 and exp(cum)
    is 0 in fp32.  Every decay is an exp of a difference of cum, so the
    gradients stay finite and match JAX's (whose chunk of 50 keeps cum
    above the underflow)."""
    d = _inputs(1, 150, 2, 8, 16, seed=7)
    d["A"] = np.array([-16.0, -1.0], np.float32)
    d["dt"] = np.full_like(d["dt"], 2.0)
    got = _port(d, 64)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_rel(got, _jax_vjp(d, 64))


def test_plain_backward_bf16_rounds_each_gradient_once():
    """bf16 x, B, C and dy: the plain version widens them exactly, computes
    in fp32 and rounds dx, dB and dC once to bf16 (ddt, dA and dD stay
    fp32), so it equals the fp32 backward of the widened inputs with those
    three rounded."""
    d = _inputs(1, 70, 3, 16, 32, seed=3)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    narrow = {k: t[k].to(torch.bfloat16) for k in ("x", "B", "C", "dy")}
    got = ref.ssd_scan_backward(narrow["x"], t["dt"], t["A"], narrow["B"],
                                narrow["C"], t["D"], narrow["dy"],
                                t["dfinal"], chunk=16)
    want = ref.ssd_scan_backward(
        narrow["x"].float(), t["dt"], t["A"], narrow["B"].float(),
        narrow["C"].float(), t["D"], narrow["dy"].float(), t["dfinal"],
        chunk=16)
    for name, g, w in zip(NAMES, got, want):
        if name in ("dx", "dB", "dC"):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g, w.to(torch.bfloat16)), name
        else:
            assert g.dtype == torch.float32
            assert torch.equal(g, w), name


def test_ops_backward_on_the_cpu_is_the_plain_version():
    """The wrapper on CPU tensors: ``ref.ssd_scan_backward``, no launch."""
    d = _inputs(1, 40, 2, 8, 16, seed=4)
    t = [torch.from_numpy(d[k]) for k in ("x", "dt", "A", "B", "C", "D",
                                          "dy", "dfinal")]
    before = dict(ops.launches)
    got = ops.ssd_scan_backward(*t, chunk=16)
    want = ref.ssd_scan_backward(*t, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launches == before


def _model_views(b, s, h, p, n, seed, dtype=torch.float32):
    """Leaves shaped as the model makes them: x, B, C column slices of one
    (b, s, h·p + 2n) conv output; dt = softplus(raw); A = -exp(A_log); D.
    The decays are those of tests/test_kernels.py's draws (dt about 0.08,
    A in [-1.5, -0.5]), where fp32 sums of dA keep about six digits."""
    rng = np.random.default_rng(seed)
    leaves = dict(
        buf=torch.tensor(rng.standard_normal((b, s, h * p + 2 * n)) * 0.5,
                         dtype=dtype),
        raw=torch.tensor(rng.standard_normal((b, s, h)) - 2.5,
                         dtype=torch.float32),
        A_log=torch.tensor(np.log(np.linspace(0.5, 1.5, h)),
                           dtype=torch.float32),
        D=torch.ones(h))
    for t in leaves.values():
        t.requires_grad_(True)

    def operands():
        buf = leaves["buf"]
        x = buf[..., :h * p].reshape(b, s, h, p)
        return (x, torch.nn.functional.softplus(leaves["raw"]),
                -torch.exp(leaves["A_log"]), buf[..., h * p:h * p + n],
                buf[..., h * p + n:], leaves["D"])
    return leaves, operands


@pytest.mark.parametrize("s,chunk", [(64, 16), (70, 16), (45, 32)])
def test_ssd_scan_function_matches_autograd_of_ssd_chunked(s, chunk):
    """``ops.SSDScan`` (and ``ops.ssd_scan`` under grad, which goes through
    it) on CPU tensors, fed the model's strided views, against autograd of
    the port's ``ssd_chunked`` on the same leaves: a loss of y and of the
    final state, each leaf's gradient within 1e-5 of its max |grad|."""
    b, h, p, n = 2, 3, 8, 16
    leaves, operands = _model_views(b, s, h, p, n, seed=s)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s, h, p)).astype(np.float32))
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, h, p, n)).astype(np.float32))

    def grads(scan):
        y, final = scan(*operands())
        loss = (y * w).sum() + (final * v).sum()
        return torch.autograd.grad(loss, list(leaves.values()))

    via_fn = grads(lambda *a: ops.SSDScan.apply(*a, chunk))
    via_ops = grads(lambda *a: ops.ssd_scan(*a, chunk=chunk))
    want = grads(lambda x, dt, A, B, C, D: ssm.ssd_chunked(
        x, dt, A, B, C, ssm.jax_chunk(chunk, s), D=D))
    for g, o, w_ in zip(via_fn, via_ops, want):
        assert torch.equal(g, o)
        assert float((g - w_).abs().max()) <= REL * float(w_.abs().max())


def test_ssd_scan_function_takes_missing_cotangents():
    """Only y reaches the loss (the model's case): dfinal is None and the
    gradients equal those with a zero dfinal; only the final state: dy is
    None; neither leaves no graph to walk; serving (no grad) returns
    outputs without one."""
    b, s, h, p, n = 1, 40, 2, 8, 16
    leaves, operands = _model_views(b, s, h, p, n, seed=9)
    y, _ = ops.SSDScan.apply(*operands(), 16)
    g_y = torch.autograd.grad(y.sum(), list(leaves.values()))
    y, final = ops.SSDScan.apply(*operands(), 16)
    g_both = torch.autograd.grad(y.sum() + 0.0 * final.sum(),
                                 list(leaves.values()))
    assert all(torch.equal(a, c) for a, c in zip(g_y, g_both))
    _, final = ops.SSDScan.apply(*operands(), 16)
    g_f = torch.autograd.grad(final.sum(), list(leaves.values()))
    assert all(bool(torch.isfinite(g).all()) for g in g_f)
    assert float(g_f[0].abs().max()) > 0
    with torch.no_grad():
        y, final = ops.ssd_scan(*operands(), chunk=16)
    assert y.grad_fn is None and final.grad_fn is None


def _strided_case():
    """x, B, C and dy as the model hands them in (column slices of one
    conv output; dy dense)."""
    buf = torch.zeros(1, 70, 4 * 16 + 2 * 32)
    x = buf[..., :64].reshape(1, 70, 4, 16)
    return dict(x=x, dt=torch.zeros(1, 70, 4), A=torch.zeros(4),
                B=buf[..., 64:96], C=buf[..., 96:], D=torch.zeros(4),
                dy=torch.zeros(1, 70, 4, 16), dfinal=torch.zeros(1, 4, 16, 32))


@pytest.mark.parametrize("what,change,err", [
    ("dy shape", dict(dy=lambda t: t[:, :60]), ValueError),
    ("dy dtype", dict(dy=lambda t: t.to(torch.bfloat16)), TypeError),
    ("dy stride", dict(dy=lambda t: t.transpose(2, 3)), ValueError),
    ("dfinal shape", dict(dfinal=lambda t: t[..., :16]), ValueError),
    ("dfinal dtype", dict(dfinal=lambda t: t.double()), TypeError),
    ("dfinal stride", dict(dfinal=lambda t: t.transpose(2, 3)), ValueError),
    ("x dtype", dict(x=lambda t: t.double()), TypeError),
    ("B stride", dict(B=lambda t: t[..., ::2]), ValueError),
])
def test_backward_wrapper_checks_raise_before_launch(what, change, err):
    """The operand checks the backward wrapper runs before a launch on the
    card, exercised on CPU tensors; the model's strided slices pass, with
    a dfinal or without."""
    case = _strided_case()
    ops._check_ssd_backward(*case.values(), 16)
    ops._check_ssd_backward(*list(case.values())[:-1], None, 16)
    for name, fn in change.items():
        case[name] = fn(case[name])
    with pytest.raises(err):
        ops._check_ssd_backward(*case.values(), 16)


@pytest.mark.parametrize("chunk,p,n,ok", [
    (64, 64, 128, True), (16, 32, 32, True), (128, 16, 16, True),
    (128, 8, 16, True), (128, 64, 128, False), (64, 256, 256, False),
    (12, 8, 16, False)])
def test_backward_wrapper_checks_chunk_and_shared_memory(chunk, p, n, ok):
    """The chunks the forward takes, within a block's 227 KB of shared
    memory: mamba2-370m's training shape (chunk 64, p 64, n 128) takes
    201,728 bytes; chunk 128 at n = 128 does not fit (nor does it in the
    forward's fp32-FMA instance)."""
    assert ops.ssd_backward_smem_bytes(64, 64, 128) == 201728
    assert ops.ssd_backward_smem_bytes(16, 32, 32) == 4 * (
        2 * 16 * 36 + 32 * 36 + 2 * 16 * 20 + 2 * 16 * 36 + 8 * 16
        + 2 * 16 * 4 + 2 * 16 * 8 + 16 * 8 + 1024)
    h = 2
    x = torch.zeros(1, 70, h, p)
    args = (x, torch.zeros(1, 70, h), torch.zeros(h), torch.zeros(1, 70, n),
            torch.zeros(1, 70, n), torch.zeros(h), torch.zeros_like(x), None)
    if ok:
        ops._check_ssd_backward(*args, chunk)
    else:
        with pytest.raises(ValueError, match="chunk"):
            ops._check_ssd_backward(*args, chunk)


def test_mamba2_loss_grads_through_ssd_scan_match_jax(monkeypatch):
    """The reduced mamba2's ``loss_fn`` with ``models.ssm.ssd`` routed
    through ``ops.SSDScan`` at the config's chunk (as the card runs it;
    on the CPU the function's backward is ``ref.ssd_scan_backward``)
    against ``jax.value_and_grad`` of JAX's ``loss_fn``, at
    ``tests/test_torch_train.py``'s tolerance (loss 1e-5, each leaf 2e-5
    of its largest entry), A_log, D and dt_bias included."""
    arch = "mamba2_370m"
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch),
                               param_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 40))
    labels = np.where(rng.random((2, 40)) < 0.1, -1,
                      rng.integers(0, tcfg.vocab_size, (2, 40)))
    batch = {"tokens": tokens, "labels": labels}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    calls = []

    def through_function(x, dt, A, B, C, D, cfg):
        calls.append(1)
        return ops.SSDScan.apply(x, dt, A, B, C, D, cfg.ssm_chunk)
    monkeypatch.setattr(ssm, "ssd", through_function)
    lm = model.trainable_(convert.params_from_jax(jp, tcfg, "cpu"))
    loss = model.loss_fn(lm, batch, tcfg)
    loss.backward()
    assert len(calls) == 2 * tcfg.num_layers   # the pass and its remat
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = convert.flat_from_jax(jgrads, tcfg)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in lm.named_parameters()}
    assert {n for n in got if n.endswith(("A_log", "D", "dt_bias"))}
    for name, g in got.items():
        w = np.asarray(want[name])
        dev = np.abs(g.numpy() - w).max()
        assert dev <= 2e-5 * max(np.abs(w).max(), 1e-30), (name, dev)
