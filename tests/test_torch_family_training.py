"""Torch port: CPU rehearsals of chip_smoke.py's phases 24-26 — granite-moe,
internvl2 and seamless-m4t training through ``family_training_phase`` —
at the reduced configs on tiny kernel cases, with stand-in counters for the
flash kernel and its backward (the CPU has no kernel), so that the phases'
code runs on every CI pass: the kernels' checks, the dry run of the step,
the step against the plain-attention step, granite's scatter route against
the dense one and bit for bit, the counted loops and the resume."""
import pytest
import torch

import chip_smoke
from repro_torch.kernels import ref
from _torch_cases import one_thread, stand_in_counters  # noqa: F401

# (label, (B, H, KV, Sq, Sk, D, causal, window)): a causal GQA case and a
# cross case with queries of their own length, as the phases' cases
CASES = [("tiny causal", (1, 4, 2, 48, 48, 64, True, None)),
         ("tiny cross", (1, 4, 4, 48, 24, 64, False, None))]
STEPS, SEQ = 2, 64

PHASES = {"granite": chip_smoke.granite_training_phase,
          "internvl2": chip_smoke.vlm_training_phase,
          "seamless": chip_smoke.encdec_training_phase}


@pytest.mark.parametrize("family", sorted(PHASES))
def test_chip_smoke_training_phases_rehearse_on_cpu(family, monkeypatch,
                                                    tmp_path):
    """Each phase end to end on the CPU: every gate holds, the loop counts
    two forward calls and one backward a flash call a step (by path for the
    encoder-decoder), the resume is bit for bit; granite's scatter route
    at a capacity that drops nothing is within the limit of the dense
    route (fp32: far within), repeats bit for bit at the configured
    capacity, and is timed."""
    ops = stand_in_counters(monkeypatch, backward=True)
    devs = {}
    out = PHASES[family](torch, ops, ref, devs, device="cpu", reduced=True,
                         cases=CASES, steps=STEPS, seq=SEQ,
                         ckpt_dir=tmp_path / "ckpt")
    from repro_torch import configs
    cfg = configs.get_reduced({"granite": chip_smoke.GRANITE_TRAIN_ARCH,
                               "internvl2": chip_smoke.VLM_TRAIN_ARCH,
                               "seamless": chip_smoke.ENCDEC_TRAIN_ARCH}[
                                   family])
    calls = chip_smoke.attention_calls(cfg)
    run = out["run"]
    assert run["launches"]["flash_attention"] == 2 * calls * STEPS
    assert run["launches"]["flash_attention_backward"] == calls * STEPS
    assert run["launches_by_path"] == chip_smoke.expected_paths(cfg, STEPS)
    assert len(out["losses"]) == STEPS and out["batch"] == 2
    assert out["step_check"]["loss_dev"] == 0.0
    assert out["step_check"]["grad_dev_max"] == 0.0
    assert out["dry"]["argument_bytes"] > 0
    assert len(out["kernels"]["forward"]) == len(out["kernels"]["backward"])
    assert devs["flash_attention"]["bfloat16"] <= 2 ** -6
    if family == "granite":
        scatter = out["scatter"]
        assert scatter["bit_equal"] and scatter["dropped"] > 0
        assert scatter["grad_dev_max"] < 1e-4
        assert scatter["capacity_ample"] > SEQ
        assert out["scatter_run"]["launches"]["flash_attention"] == \
            2 * calls * chip_smoke.SCATTER_TIMED_STEPS
    if family == "seamless":
        assert calls == cfg.num_encoder_layers + 2 * cfg.num_layers
    if family == "internvl2":
        assert "ssd_train" not in out       # the card's timing only


def test_family_batches_take_jax_train_shape():
    """``family_batches`` gives JAX's train shape: the VLM's 4096 positions
    are 256 of media and 3840 of text; the encoder-decoder's frames are
    min(frontend_len, S / 4) = 1024 (``input_specs``' shapes)."""
    from repro_torch import configs
    from repro_torch.data import synthetic as data
    for arch in (chip_smoke.VLM_TRAIN_ARCH, chip_smoke.ENCDEC_TRAIN_ARCH):
        cfg = configs.get(arch)
        spec = data.input_specs(cfg, data.InputShape("train", 4096, 1,
                                                     "train"))
        small = configs.get_reduced(arch)
        got = next(chip_smoke.family_batches(torch, small, 1, 64, seed=0,
                                             device="cpu"))
        want = data.input_specs(small, data.InputShape("train", 64, 1,
                                                       "train"))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        if cfg.frontend == "vision":
            assert tuple(spec["tokens"].shape) == (1, 3840)
            assert tuple(spec["media"].shape) == (1, 256, 896)
        else:
            assert tuple(spec["enc_media"].shape) == (1, 1024, 1024)


def test_train_loop_cannot_feed_the_encoder_decoder(capsys):
    """``token_stream`` has no "enc_media": JAX's ``train_loop`` raises
    KeyError at the first step of the encoder-decoder config (its
    ``model.forward`` reads ``batch["enc_media"]``), and so does the
    port's; phase 26 drives ``make_train_step`` in a loop of its own on
    ``family_batches``."""
    import repro.configs as jconfigs
    from repro.launch.train import train_loop as jtrain_loop
    from repro_torch import configs
    from repro_torch.launch import train
    with pytest.raises(KeyError, match="enc_media"):
        jtrain_loop(jconfigs.get_reduced(chip_smoke.ENCDEC_TRAIN_ARCH),
                    steps=1, batch=1, seq=16)
    with pytest.raises(KeyError, match="enc_media"):
        train.train_loop(configs.get_reduced(chip_smoke.ENCDEC_TRAIN_ARCH),
                         steps=1, batch=1, seq=16, device="cpu")
