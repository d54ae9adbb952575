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
        ops._check_attention(*make(q, k, v), None)


def test_wrapper_checks_window_and_accept_strided_views():
    q = torch.zeros(1, 8, 4, 16).transpose(1, 2)      # (B, H, S, D) view
    k = torch.zeros(1, 8, 2, 16).transpose(1, 2)
    ops._check_attention(q, k, k, 3)
    with pytest.raises(ValueError):
        ops._check_attention(q, k, k, 0)
    # the output buffer takes q's strides, so it transposes back for free
    assert torch.empty_like(q).transpose(1, 2).is_contiguous()
