"""The LM stack in torch: the decoder-only families — dense, MoE, mamba2
and the RG-LRU hybrid (config, layers, attention, MLP, the MoE, Mamba-2
and RG-LRU mixers, blocks, model, block prefill) — and the carrier of
weights from the JAX package (``convert``).  Counterpart of
``repro.models``; the media frontends and the encoder-decoder parts wait
for a later slice of the port (ROADMAP Queue 1 item 13)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models import (attention, blocks, layers, mlp, model, moe,
                                prefill, rglru, ssm)

__all__ = ["ModelConfig", "attention", "blocks", "layers", "mlp", "model",
           "moe", "prefill", "rglru", "ssm"]
