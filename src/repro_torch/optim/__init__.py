"""Optimisation surfaces in torch.  Counterpart of ``repro.optim``: AdamW
(``adamw``, JAX's arithmetic, fp32 moments), the learning-rate schedules
(``schedule``) and the decentralized CSVM head on frozen backbone
features (``decsvm_head``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.decsvm_head import (extract_features, standardize,
                                           train_decsvm_head)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup", "extract_features", "standardize",
           "train_decsvm_head"]
