"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", arch_type="ssm",
        num_layers=48, d_model=1024, d_ff=0, vocab_size=50280,
        norm="rmsnorm", tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=64,
        ssm_groups=1, conv_width=4,
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="mamba2-370m-reduced", num_layers=2, d_model=256,
        vocab_size=512, ssm_state=32, ssm_headdim=32, ssm_chunk=16,
        param_dtype="float32")
