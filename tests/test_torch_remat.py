"""Torch port, the remat policies on the CPU: ``remat_policy="dots"`` and
``"names"`` (``torch.utils.checkpoint.create_selective_checkpoint_contexts``)
against ``"full"`` — the same loss and every gradient, bit for bit — and
against ``jax.value_and_grad(repro.models.model.loss_fn)`` under the same
policy (JAX-initialised weights, fp32, the tolerances of
``tests/test_torch_train.py``), for every family whose layers the policy
sees.  What each policy saves shows in the ops the backward runs: under
"dots" fewer ``aten.mm`` (the projections' products are kept), under
"names" the ``checkpoint_name`` op runs in the forward only (its two
tensors a layer are kept)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jconfigs
from repro.models import model as jmodel
import repro_torch.configs as tconfigs
from repro_torch.data.synthetic import token_stream
from repro_torch.models import blocks, convert, model
from _torch_cases import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
B, S = 2, 16
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
ARCHS = ["qwen3_14b", "granite_moe_1b_a400m", "mamba2_370m",
         "recurrentgemma_2b", "internvl2_1b", "seamless_m4t_large_v2"]


class _Ops(TorchDispatchMode):
    """Counts the aten ops run inside it."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _batch(cfg):
    b = {k: v.numpy() for k, v in next(token_stream(
        cfg, B, S, seed=4, device="cpu")).items()}
    rng = np.random.default_rng(9)
    if cfg.frontend == "vision":
        b["media"] = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                      * 0.02).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["enc_media"] = (rng.standard_normal((B, 8, cfg.d_model))
                          * 0.02).astype(np.float32)
    return b


def _run(cfg, jp, batch):
    """(loss, {name: grad}, ops of the backward, ops of the forward)."""
    lm = model.trainable_(convert.params_from_jax(jp, cfg, "cpu"))
    with _Ops() as fwd:
        loss = model.loss_fn(lm, batch, cfg)
    with _Ops() as bwd:
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in lm.named_parameters()}, \
        bwd.n, fwd.n


@pytest.mark.parametrize("policy", ["dots", "names"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_gives_full_grads_and_jax(arch, policy):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32", remat_policy=policy)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch),
                               param_dtype="float32", remat_policy=policy)
    jp = jmodel.init_params(jcfg, KEY)
    batch = _batch(tcfg)
    loss, grads, bwd, fwd = _run(tcfg, jp, batch)
    floss, fgrads, fbwd, _ = _run(dataclasses.replace(
        tcfg, remat_policy="full"), jp, batch)
    assert torch.equal(loss, floss)
    for name, g in fgrads.items():
        assert (g is None) == (grads[name] is None), name
        if g is not None:
            assert torch.equal(grads[name], g), name
    mm = torch.ops.aten.mm.default
    if policy == "dots":
        assert bwd.get(mm, 0) < fbwd.get(mm, 0)
    else:
        assert fwd.get(blocks.NAMED_OP, 0) == 2 * (tcfg.num_layers + (
            tcfg.num_encoder_layers if tcfg.is_encoder_decoder else 0)) - \
            tcfg.num_layers * (tcfg.arch_type == "ssm")
        assert bwd.get(blocks.NAMED_OP, 0) == 0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    want = convert.flat_from_jax(jgrads, tcfg)
    for name, g in grads.items():
        w = np.asarray(want[name])
        got = np.zeros_like(w) if g is None else g.numpy()
        dev = np.abs(got - w).max()
        assert dev <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (name, dev)


def test_unknown_policy_raises():
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen3_14b"),
                              remat_policy="offload")
    lm = model.init_params(cfg, seed=0, device="cpu", trainable=True)
    with pytest.raises(ValueError, match="offload"):
        model.loss_fn(lm, _batch(cfg), cfg)
