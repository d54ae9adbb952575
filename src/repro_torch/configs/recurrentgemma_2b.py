"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427]"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", arch_type="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        norm="rmsnorm", mlp_act="gelu", tie_embeddings=True,
        block_pattern=("rec", "rec", "attn"), lru_width=2560,
        sliding_window=2048, conv_width=4,
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="recurrentgemma-2b-reduced", num_layers=2,
        d_model=256, num_heads=4, num_kv_heads=1, head_dim=64, d_ff=512,
        vocab_size=512, lru_width=256, sliding_window=64,
        block_pattern=("rec", "attn"),
        param_dtype="float32")
