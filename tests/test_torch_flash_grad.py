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
    same bf16 inputs, and within one bf16 ulp (+ 1e-6 of the largest
    entry) of the same closed form on fp32 copies of them: each gradient
    is rounded once."""
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
        closed = ref.mha_backward(*det, out.detach(), dot, causal=causal,
                                  window=window)
        for g, c in zip(grads, closed):
            assert torch.equal(g, c)
        wide = ref.mha_backward(*(t.float() for t in det),
                                out.detach().float(), dot.float(),
                                causal=causal, window=window)
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
