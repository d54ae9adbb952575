"""The LM stack in torch: every family of the registry — dense, MoE,
mamba2, the RG-LRU hybrid, the VLM behind its media prefix and the
encoder-decoder with cross-attention (config, layers, attention, MLP, the
MoE, Mamba-2 and RG-LRU mixers, blocks, model, block prefill) — and the
carrier of weights from the JAX package (``convert``).  Counterpart of
``repro.models``; the media and speech frontends are stubs there too
(precomputed embeddings)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models import (attention, blocks, layers, mlp, model, moe,
                                prefill, rglru, ssm)

__all__ = ["ModelConfig", "attention", "blocks", "layers", "mlp", "model",
           "moe", "prefill", "rglru", "ssm"]
