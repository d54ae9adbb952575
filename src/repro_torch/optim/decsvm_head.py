"""The paper's technique as a framework feature: a decentralized
elastic-net convoluted-SVM classification head trained on frozen backbone
features.

Counterpart of ``repro.optim.decsvm_head``.  The backbone (any family of
the registry) is replicated everywhere; each network node
(hospital, region, pod) holds private sequences.  Features are extracted
locally, and the sparse linear head is learned with Algorithm 1: each
round a node sends one (d_model+1)-vector to its one-hop neighbours, never
the data.

``extract_features`` runs the reference's trunk (embedding with learned
positions where the config has them, the decoder's block stack, the final
norm; no LM head and no media prefix; for an encoder-decoder, no encoder
and no cross-attention: the decoder stack alone over the tokens), which for
a hybrid stack differs from ``model.forward`` in two ways, both kept here
because the port is held to the reference:

- layer order: the trunk runs each pattern position's stacked layers to
  the end before it starts the next (for recurrentgemma-2b layers 0, 3,
  ..., 21, then 1, 4, ..., 22, then 2, 5, ..., 23, then the tail 24 and
  25), where ``forward`` interleaves them 0, 1, 2, ...;
- window: its hybrid branch passes no window to the attention layers,
  where ``forward`` passes the sliding window; a stack of one kind gets
  ``cfg.sliding_window`` in both.

The two orders agree only when the pattern repeats once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import metrics, tuning
from repro_torch.core.admm import (ADMMConfig, as_f32, decsvm_fit,
                                   resolve_device)
from repro_torch.models import blocks, layers
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def trunk_order(cfg: ModelConfig) -> Tuple[List[int], Optional[int]]:
    """(the layers in the order the reference trunk runs them, the window
    it gives their attention)."""
    if len(set(blocks.block_kinds(cfg))) == 1:
        return list(range(cfg.num_layers)), cfg.sliding_window
    pat, n_rep, _ = M.hybrid_layout(cfg)
    grouped = [g * len(pat) + j for j in range(len(pat))
               for g in range(n_rep)]
    return grouped + list(range(n_rep * len(pat), cfg.num_layers)), None


def extract_features(params: M.LM, cfg: ModelConfig, tokens,
                     batch_size: int = 64) -> Tensor:
    """Mean-pooled final-layer features of each sequence, (N, d_model) in
    the model's dtype on the params' device.  tokens: (N, S) ids."""
    order, window = trunk_order(cfg)
    kinds = blocks.block_kinds(cfg)
    tokens = M._tokens(tokens, params.device)
    outs = []
    with torch.inference_mode():
        for i in range(0, tokens.shape[0], batch_size):
            x = M._embed_tokens(params, tokens[i:i + batch_size], cfg)
            for l in order:
                x, _ = blocks.block_forward(params.layers[l], x, cfg,
                                            kinds[l], causal=True,
                                            window=window)
            x = layers.apply_norm(x, params.final_norm, cfg.norm)
            outs.append(torch.mean(x, dim=1))
    return torch.cat(outs, dim=0)


def standardize(features, device=None):
    """features (m, n, d) -> (X (m, n, d+1) fp32: an intercept column, then
    the features standardised by their mean and population std over all
    nodes' rows (+1e-6); mu (d,); sd (d,)), on ``device`` (default the
    features' device for a tensor, else CUDA)."""
    dev = resolve_device(features, device)
    F = as_f32(features, dev)
    m, n, _ = F.shape
    mu = torch.mean(F, dim=(0, 1), keepdim=True)
    sd = torch.std(F, dim=(0, 1), keepdim=True, correction=0) + 1e-6
    X = torch.cat([torch.ones((m, n, 1), dtype=torch.float32, device=dev),
                   (F - mu) / sd], dim=-1)
    return X, mu[0, 0], sd[0, 0]


def train_decsvm_head(features, labels, W, acfg: ADMMConfig, *,
                      tune: bool = False, lams=None, num: int = 12,
                      criterion: str = "bic", cv_folds: int = 5,
                      mode: str = "warm", rho=None, cv_rho=None,
                      device=None) -> Tuple[Tensor, Dict]:
    """features: (m, n, d); labels: (m, n) in {-1, +1}; W: (m, m) adjacency.

    With ``tune=True`` (or an explicit ``lams`` grid) the l1 level is
    selected on the device by the lambda-path engine
    (``tuning.select_lambda_path``) under the modified BIC or k-fold CV;
    ``acfg.lam`` is then only the level of the untuned call.  ``rho`` (m,)
    and ``cv_rho`` (k, m) optionally fix the step sizes (as in the
    drivers); ``device`` defaults to the features' device for a tensor,
    else CUDA.  The design X is built on that device.  Returns (B (m, d+1)
    per-node heads with intercept, on the device; info dict).
    """
    X, mu, sd = standardize(features, device)
    dev = X.device
    y, Wt = as_f32(labels, dev), as_f32(W, dev)
    best_lam = acfg.lam
    if tune or lams is not None:
        best_lam, _, _, res = tuning.select_lambda_path(
            X, y, Wt, acfg, lams=lams, num=num, mode=mode,
            criterion=criterion, cv_folds=cv_folds, rho=rho, cv_rho=cv_rho,
            device=dev)
        B = res.best_B
    else:
        B = decsvm_fit(X, y, Wt, acfg, rho=rho, device=dev)
    Bn = B.cpu().numpy()
    margins = torch.einsum("mnp,mp->mn", X, B).cpu().numpy()
    info = {
        "train_accuracy": metrics.margin_accuracy(margins, y.cpu().numpy()),
        "consensus_gap": metrics.consensus_gap(Bn),
        "mean_support": metrics.mean_support_size(Bn, tol=1e-6),
        "normalizer": (mu.cpu().numpy(), sd.cpu().numpy()),
        "lam": float(best_lam),
        "tuned": bool(tune or lams is not None),
    }
    return B, info
