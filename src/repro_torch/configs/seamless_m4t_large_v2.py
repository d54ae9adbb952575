"""seamless-m4t-large-v2 [audio]: enc-dec, 24L enc + 24L dec, d_model=1024
16H (GQA kv=16) d_ff=8192 vocab=256206 — speech frontend STUBBED as
precomputed frame embeddings.  [arXiv:2308.11596]"""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", arch_type="audio",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=8192, vocab_size=256206,
        norm="layernorm", mlp_act="gelu", pos_embedding="learned",
        is_encoder_decoder=True, num_encoder_layers=24,
        frontend="audio", frontend_len=1024,   # mel+conv codec frames (stub)
        param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="seamless-m4t-large-v2-reduced", num_layers=2,
        num_encoder_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512, frontend_len=32,
        param_dtype="float32")
