"""Optimisation surfaces in torch.  Counterpart of ``repro.optim``: the
decentralized CSVM head on frozen backbone features (``decsvm_head``).
AdamW and the learning-rate schedules come with the training slice of the
port (ROADMAP Queue 1 item 13.4)."""
from repro_torch.optim.decsvm_head import (extract_features, standardize,
                                           train_decsvm_head)

__all__ = ["extract_features", "standardize", "train_decsvm_head"]
