"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT (STUB frontend) + InternLM2/Qwen2-0.5B-class LM.
[arXiv:2404.16821]"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", arch_type="vlm",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151655,
        norm="rmsnorm", mlp_act="swiglu", attn_bias=True,
        tie_embeddings=True,
        frontend="vision", frontend_len=256,   # ViT patch embeddings (stub)
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="internvl2-1b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        frontend_len=16, param_dtype="float32")
