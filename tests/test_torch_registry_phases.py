"""Torch port: CPU rehearsals of chip_smoke.py's phases 27-29 — glm4-9b,
command-r-35b and granite-moe-1b-a400m serve and train through
``registry_phase`` — at the reduced configs on tiny kernel cases, with
stand-in counters for the flash kernel and its backward (the CPU has no
kernel), so that the phases' code runs on every CI pass: the engine with
block prefill, the kernel against the plain attention inside the model
with its control, glm4's block prefill against token-wise decode (and its
fp32 copy), command-r's dry decode step, then the kernels' checks, the dry
run of the step at the phase's depth, the step against the
plain-attention step, granite's scatter route, the counted loops and the
resume."""
import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.serving import engine
from _torch_cases import one_thread, stand_in_counters  # noqa: F401

# (label, (B, H, KV, Sq, Sk, D, causal, window)): a causal case of a GQA
# group of 4, as the phases' training shapes
CASES = [("tiny causal", (1, 8, 2, 48, 48, 64, True, None))]
STEPS, SEQ = 2, 64
# the engine's traffic at a tiny size: four prompts, 40 positions a slot;
# the in-model and token-wise limits of fp32 (the reduced configs'): both
# paths run the plain attention here
SERVE = dict(prompts=(20, 9, 5, 3), max_len=40, model_prompt=30,
             model_tol=1e-4)

PHASES = {"glm4": (chip_smoke.glm4_phase, chip_smoke.GLM4_ARCH, 3),
          "command-r": (chip_smoke.command_r_phase,
                        chip_smoke.COMMAND_R_ARCH, None),
          "granite-1b": (chip_smoke.granite1b_phase,
                         chip_smoke.GRANITE1B_ARCH, None)}


@pytest.mark.parametrize("family", sorted(PHASES))
def test_chip_smoke_registry_phases_rehearse_on_cpu(family, monkeypatch,
                                                    tmp_path):
    """Each phase end to end on the CPU: every request finishes with one
    flash call a layer a prefill; the in-model limit holds with the control
    above it; glm4's token-wise decode agrees with block prefill (and its
    fp32 copy gives the same tokens); command-r's dry decode step is read;
    the training loop counts two forward calls and one backward a layer a
    step at the phase's depth (glm4 cut to a depth of its own here), the
    step against plain and the resume hold; granite's scatter route is
    held to its dense route and repeats bit for bit."""
    phase, arch, layers = PHASES[family]
    ops = stand_in_counters(monkeypatch, backward=True)
    serve = dict(SERVE)
    if family == "glm4":
        serve["tokenwise_tol"] = 1e-4
    kw = dict(device="cpu", reduced=True, cases=CASES, steps=STEPS, seq=SEQ,
              ckpt_dir=tmp_path / "ckpt", serve_over=serve)
    if layers is not None:
        kw["layers"] = layers
    devs = {}
    out = phase(torch, ops, ref, engine, devs, **kw)
    cfg = configs.get_reduced(arch)
    served = out["served"]
    assert served["serve"]["launches"] == len(SERVE["prompts"]) * \
        cfg.num_layers
    assert served["in_model"]["max_abs_dev"] <= SERVE["model_tol"] < \
        served["in_model"]["control_dev"]
    if family == "glm4":
        bf16, fp32 = served["tokenwise"]
        assert fp32["equal"] and fp32["dtype"] == "float32"
        assert bf16["first_logits_dev"] <= 1e-4 < bf16["control_dev"]
    else:
        assert "tokenwise" not in served
    if family == "command-r":
        assert served["dry_decode"]["argument_bytes"] > 0
    L = layers or cfg.num_layers
    run = out["run"]
    assert run["launches"]["flash_attention"] == 2 * L * STEPS
    assert run["launches"]["flash_attention_backward"] == L * STEPS
    assert len(out["losses"]) == STEPS
    assert out["step_check"]["grad_dev_max"] == 0.0
    assert out["dry"]["argument_bytes"] > 0
    assert devs["flash_attention_backward"]["bfloat16"] >= 0.0
    if family == "granite-1b":
        assert out["scatter"]["bit_equal"]
        assert out["scatter"]["tol"] == chip_smoke.GRANITE1B_SCATTER_TOL


def test_registry_kernel_cases_split_only_the_long_groups():
    """The kernel cases of phases 27-29 leave those of phases 24-26 as they
    were, and pass B of the backward splits only glm4-9b's group (16 heads
    x 4096 queries: 4 splits of 4 heads) and command-r-35b's (8: 2 of 4),
    each block's chain within ``ops.BACKWARD_CHAIN_B`` k16 steps; every
    earlier training shape keeps the whole group in one block."""
    from repro_torch.kernels import ops
    want = {"glm4-9b training": 4, "command-r-35b training": 2,
            "granite-moe-1b-a400m training": 1}
    for arch, cases in chip_smoke.FAMILY_KERNEL_CASES.items():
        for label, (B, H, KV, S, Sk, D, causal, window) in cases:
            splits = ops.backward_splits(H, KV, S, D, "wgmma")
            assert splits == want.get(label, H // KV if D == 256 else 1)
            assert (H // KV // splits) * -(-S // 64) * 4 <= \
                ops.BACKWARD_CHAIN_B or D == 256
    assert set(chip_smoke.FAMILY_KERNEL_CASES) >= {
        chip_smoke.GLM4_ARCH, chip_smoke.COMMAND_R_ARCH,
        chip_smoke.GRANITE1B_ARCH, chip_smoke.GRANITE_TRAIN_ARCH,
        chip_smoke.VLM_TRAIN_ARCH, chip_smoke.ENCDEC_TRAIN_ARCH}
