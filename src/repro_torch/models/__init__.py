"""The LM stack in torch: the dense decoder-only families and mamba2
(config, layers, attention, MLP, the Mamba-2 mixer, blocks, model, block
prefill) and the carrier of weights from the JAX package (``convert``).
Counterpart of ``repro.models``; the MoE, RG-LRU and encoder-decoder parts
wait for later slices of the port (ROADMAP Queue 1 item 13)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models import (attention, blocks, layers, mlp, model,
                                prefill, ssm)

__all__ = ["ModelConfig", "attention", "blocks", "layers", "mlp", "model",
           "prefill", "ssm"]
