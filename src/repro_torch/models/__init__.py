"""The LM stack in torch: the dense decoder-only families (config,
layers, attention, MLP, blocks, model, block prefill) and the carrier of
weights from the JAX package (``convert``).  Counterpart of
``repro.models``; the MoE, SSM, RG-LRU and encoder-decoder parts wait for
later slices of the port (ROADMAP Queue 1 item 13)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models import attention, blocks, layers, mlp, model, prefill

__all__ = ["ModelConfig", "attention", "blocks", "layers", "mlp", "model",
           "prefill"]
