"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", arch_type="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155,
        norm="rmsnorm", mlp_act="swiglu", tie_embeddings=True,
        num_experts=32, num_experts_per_tok=8,
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="granite-moe-1b-a400m-reduced", num_layers=2,
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=128,
        vocab_size=512, num_experts=4, num_experts_per_tok=2,
        param_dtype="float32")
