"""Torch port, the decentralized CSVM head on frozen backbones
(``repro_torch.optim.decsvm_head``) on the CPU, against the JAX package's
``repro.optim.decsvm_head`` on the same numpy inputs and JAX-initialised
weights: the trunk's mean-pooled features for a dense, an SSM, an MoE and
a hybrid backbone (the hybrid with 5 layers, so that the reference's
grouped layer order differs from ``forward``'s); the head fit given the
same features and JAX's rho, untuned under every backend and tuned; the
bars of ``tests/test_system.py::test_decentralized_head_on_backbone_
features`` end to end; and ``launch.decentralized_head`` at a small size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import ADMMConfig, metrics, solver
from repro.core.graph import erdos_renyi
from repro.models import model as jmodel
from repro.optim import decsvm_head as jhead
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro_torch.launch import decentralized_head
from repro_torch.models import convert, model
from repro_torch.optim import decsvm_head as head
from _torch_cases import one_thread, stand_in_counters  # noqa: F401

# fp32 features: the tier of tests/test_prefill.py; B: the fit tier of
# tests/test_solver.py
ATOL = 5e-5
ATOL_B = 1e-5
KEY = jax.random.PRNGKey(0)
BACKBONES = {"qwen3_14b": {}, "mamba2_370m": {}, "granite_moe_1b_a400m": {},
             "recurrentgemma_2b": {"num_layers": 5}}


def _pair(arch, **over):
    jcfg = jconfigs.get_reduced(arch, **over)
    tcfg = tconfigs.get_reduced(arch, **over)
    jp = jmodel.init_params(jcfg, KEY)
    return jcfg, jp, tcfg, convert.params_from_jax(jp, tcfg, "cpu")


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def backbone(request):
    return (request.param,) + _pair(request.param,
                                    **BACKBONES[request.param])


def test_features_match_jax(backbone):
    """Seven sequences in batches of 3 (a ragged last batch)."""
    arch, jcfg, jp, tcfg, tp = backbone
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (7, 12))
    want = jhead.extract_features(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  batch_size=3)
    got = head.extract_features(tp, tcfg, toks, batch_size=3)
    assert got.shape == (7, jcfg.d_model) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_hybrid_trunk_order_differs_from_forward(backbone):
    """The reference trunk walks a hybrid's pattern stacks one after
    another (layers 0, 2, 1, 3, then the tail 4, at pattern (rec, attn)
    and 5 layers), so its features differ from the mean-pooled pre-head
    forward, which interleaves them; for a stack of one kind they agree."""
    arch, jcfg, jp, tcfg, tp = backbone
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 12))
    order, window = head.trunk_order(tcfg)
    x, _ = model.hidden(tp, {"tokens": toks}, tcfg)
    dev = float((head.extract_features(tp, tcfg, toks)
                 - x.mean(dim=1)).abs().max())
    if arch == "recurrentgemma_2b":
        assert order == [0, 2, 1, 3, 4] and window is None
        assert dev > 1e-2, dev
    else:
        assert order == list(range(tcfg.num_layers))
        assert window == tcfg.sliding_window
        assert dev < 1e-6, dev


@pytest.fixture(scope="module")
def system():
    """tests/test_system.py's head problem: reduced qwen3-14b, m = 4
    nodes of n = 40 sequences of 16 tokens, labels from a sparse
    hyperplane with 10% flips, W erdos_renyi(4, 0.8); the features
    extracted by JAX, JAX's step sizes for the standardised design, and
    JAX's untuned head (lam 0.01, h 0.3, 500 rounds)."""
    jcfg, jp, tcfg, tp = _pair("qwen3_14b")
    rng = np.random.default_rng(0)
    m, n, S = 4, 40, 16
    toks = rng.integers(0, jcfg.vocab_size, (m, n, S))
    feats = np.asarray(jhead.extract_features(
        jp, jcfg, jnp.asarray(toks.reshape(-1, S), jnp.int32)))
    feats = feats.reshape(m, n, -1)
    w_true = np.zeros(feats.shape[-1])
    w_true[:8] = rng.standard_normal(8)
    margin = np.einsum("mnd,d->mn", feats - feats.mean((0, 1)), w_true)
    labels = np.sign(margin + 1e-9).astype(np.float32)
    labels = np.where(rng.random(labels.shape) < 0.1, -labels, labels)
    W = erdos_renyi(m, 0.8, seed=1)
    want = jhead.train_decsvm_head(feats, labels, W, ADMMConfig(
        lam=0.01, h=0.3, max_iter=500))
    return dict(toks=toks, feats=feats, labels=labels, W=W, tp=tp,
                tcfg=tcfg, rho=_jax_rho(feats, ADMMConfig(h=0.3)),
                want=want)


def _jax_rho(feats, acfg):
    """JAX's rho for the head's standardised design (the two packages
    draw the power iteration's start from different generators)."""
    mu = feats.mean(axis=(0, 1), keepdims=True)
    sd = feats.std(axis=(0, 1), keepdims=True) + 1e-6
    X = np.concatenate([np.ones((*feats.shape[:2], 1), np.float32),
                        ((feats - mu) / sd).astype(np.float32)], axis=-1)
    return np.asarray(solver.compute_rho(jnp.asarray(X), acfg.h,
                                         acfg.kernel, acfg.rho_safety))


@pytest.mark.parametrize("backend", ["jnp", "megakernel", "pallas"])
def test_untuned_head_matches_jax(system, backend):
    """Given the same features and JAX's rho, B within 1e-5 of JAX's fit
    (under its ``jnp`` update: the kernels' plain versions compute the
    same fp32 function), and the same info."""
    want, winfo = system["want"]
    B, info = head.train_decsvm_head(
        system["feats"], system["labels"], system["W"],
        ADMMConfig(lam=0.01, h=0.3, max_iter=500, backend=backend),
        rho=system["rho"], device="cpu")
    assert B.device.type == "cpu" and B.shape == (4, 257)
    assert np.abs(B.numpy() - np.asarray(want)).max() <= ATOL_B
    assert sorted(info) == sorted(winfo)
    assert info["lam"] == winfo["lam"] == 0.01 and not info["tuned"]
    assert info["train_accuracy"] == pytest.approx(winfo["train_accuracy"],
                                                   abs=1 / 160)
    for name in ("consensus_gap", "mean_support"):
        assert info[name] == pytest.approx(winfo[name], abs=2e-5), name
    for got, want_n in zip(info["normalizer"], winfo["normalizer"]):
        np.testing.assert_allclose(got, want_n, rtol=1e-5, atol=1e-6)


def test_head_on_backbone_features_meets_the_system_bars(system):
    """tests/test_system.py::test_decentralized_head_on_backbone_features
    end to end on the port: its own features (within 5e-5 of JAX's), then
    the head: finite, consensus gap < 2e-2, train accuracy > 0.75."""
    S = system["toks"].shape[-1]
    feats = head.extract_features(system["tp"], system["tcfg"],
                                  system["toks"].reshape(-1, S))
    feats = feats.reshape(system["feats"].shape)
    np.testing.assert_allclose(feats.numpy(), system["feats"], atol=ATOL,
                               rtol=0)
    B, info = head.train_decsvm_head(feats, system["labels"], system["W"],
                                     ADMMConfig(lam=0.01, h=0.3,
                                                max_iter=500))
    assert torch.isfinite(B).all()
    assert metrics.consensus_gap(B.numpy()) < 2e-2
    assert info["train_accuracy"] > 0.75, info


def test_tuned_head_matches_jax():
    """tests/test_fit_serving.py::test_decsvm_head_tuned_fit on the port
    (JAX's rho injected): the same selected lambda, B within 1e-5, and
    the untuned call keeps acfg.lam."""
    rng = np.random.default_rng(0)
    m, n, d = 4, 60, 16
    beta = np.zeros(d)
    beta[:3] = [1.5, -2.0, 1.0]
    feats = rng.standard_normal((m, n, d)).astype(np.float32)
    labels = np.sign(feats @ beta + 0.1 * rng.standard_normal((m, n)))
    W = erdos_renyi(m, 0.7, seed=0)
    acfg = ADMMConfig(lam=0.05, max_iter=120)
    want, winfo = jhead.train_decsvm_head(feats, labels, W, acfg, tune=True,
                                          num=4, mode="batched")
    rho = _jax_rho(feats, acfg)
    B, info = head.train_decsvm_head(feats, labels, W, acfg, tune=True,
                                     num=4, mode="batched", rho=rho,
                                     device="cpu")
    assert info["tuned"] and info["lam"] > 0
    assert info["lam"] == pytest.approx(winfo["lam"], rel=1e-6)
    assert info["train_accuracy"] > 0.8
    assert np.abs(B.numpy() - np.asarray(want)).max() <= ATOL_B
    _, info0 = head.train_decsvm_head(feats, labels, W, acfg, rho=rho,
                                      device="cpu")
    assert not info0["tuned"] and info0["lam"] == acfg.lam


def test_entry_points_need_a_card_unless_told():
    """The head fits on the features' device, or on CUDA for numpy
    features (raising without a card); the launcher likewise.  The VLM
    backbone is built on the card unless told; on the CPU its features
    are the reference's."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    feats = np.zeros((2, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        head.train_decsvm_head(feats, np.ones((2, 4)), np.eye(2),
                               ADMMConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decentralized_head.run(m=2, n=4, S=4, log=lambda *a: None)
    cfg = tconfigs.get_reduced("internvl2_1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg)
    jcfg, jp, tcfg, tp = _pair("internvl2_1b")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 6))
    np.testing.assert_allclose(
        head.extract_features(tp, tcfg, toks).numpy(),
        np.asarray(jhead.extract_features(jp, jcfg,
                                          jnp.asarray(toks, jnp.int32))),
        atol=ATOL, rtol=0)


def test_launch_decentralized_head_on_cpu():
    """The torch counterpart of examples/decentralized_head.py at a small
    size: 4 nodes of 24 sequences of 8 tokens on a ring, the gather
    schedule at one rank."""
    lines = []
    out = decentralized_head.run(device="cpu", m=4, n=24, S=8,
                                 log=lines.append)
    assert out["schedule"] == "gather" and out["B"].shape == (4, 257)
    assert np.isfinite(out["B"]).all()
    assert out["accuracy"] > 0.75 and out["consensus_gap"] < 2e-2
    assert any(line.startswith("train accuracy") for line in lines)


def test_hyperplane_labels_are_the_examples():
    """The launcher's labels (shared with chip_smoke.py's head phase) are
    the example's: a sparse hyperplane over the first 10 coordinates of
    the centred features, then 5% of the signs flipped, from one rng."""
    feats = np.random.default_rng(3).standard_normal((4, 50, 32))
    got = decentralized_head.hyperplane_labels(feats, np.random.default_rng(7))
    rng = np.random.default_rng(7)
    w_true = np.zeros(32)
    w_true[:10] = rng.standard_normal(10)
    y = np.sign((feats - feats.mean((0, 1))) @ w_true)
    flip = rng.random(y.shape) < 0.05
    assert got.dtype == np.float32 and flip.any()
    np.testing.assert_array_equal(got, np.where(flip, -y, y))


def test_chip_smoke_head_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's head phase end to end on the CPU at a tiny size:
    the extraction's launch count, the features against the plain
    attention, and the four fits against jnp with their launch counts."""
    import chip_smoke
    ops = stand_in_counters(monkeypatch)
    cfg = tconfigs.get_reduced("qwen3_14b")
    params = model.init_params(cfg, seed=0, device="cpu")
    out = chip_smoke.head_phase(
        torch, tcore, ops, cfg, params, shape=(4, 20, 8), plain_seqs=8,
        tune_num=3, admm=dict(lam=0.02, h=0.3, max_iter=25))
    assert out["flash_launches"] == cfg.num_layers * 2   # 80 = 64 + 16
    # the trunk's operations from the config: q, k, v, o and the SwiGLU
    # matrices of every layer, and causal attention over S = 8
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    weights = cfg.num_layers * (2 * d * H * D + 2 * d * KV * D
                                + 3 * d * cfg.d_ff)
    assert out["trunk_flops"] == 80 * (2 * weights * 8 + cfg.num_layers * 4
                                       * H * D * 8 * 9 // 2)
    assert out["fit_launches"] == {"csvm_round_block": 1 + 3,
                                   "csvm_local_update": 25,
                                   "csvm_block_update": 25}
    assert set(out["fits"]) == set(chip_smoke.HEAD_FITS)
    assert out["features_kernel_vs_plain"]["max_abs_dev"] == 0.0
    for fit in out["fits"].values():
        assert fit["max_abs_dev"] <= 1e-5 and 0.0 <= fit["train_accuracy"]
