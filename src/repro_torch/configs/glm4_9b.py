"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE (partial 0.5), GQA.  [hf:THUDM/glm-4-9b]"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", arch_type="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        head_dim=128, d_ff=13696, vocab_size=151552,
        norm="rmsnorm", rope_fraction=0.5, mlp_act="swiglu", attn_bias=True,
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="glm4-9b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        param_dtype="float32")
