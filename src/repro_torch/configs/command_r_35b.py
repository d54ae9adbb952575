"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias, LayerNorm.  [hf:CohereForAI/c4ai-command-r-v01]"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", arch_type="dense",
        num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22528, vocab_size=256000,
        norm="layernorm", mlp_act="swiglu", attn_bias=False,
        rope_theta=8e6, tie_embeddings=True,
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="command-r-35b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        param_dtype="float32")
