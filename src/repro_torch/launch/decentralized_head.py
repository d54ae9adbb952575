"""The paper's technique as a framework feature, in torch: decentralized
training of a sparse elastic-net CSVM head on frozen backbone features.

Scenario: 8 "hospitals" (nodes) each hold private sequences; the qwen3
backbone (reduced, random weights from seed 0) is frozen everywhere; only
the (d_model+1)-dim sparse head is learned, by one-hop ADMM message
passing (Algorithm 1) through ``decentral.decsvm_fit_sharded`` on the
("node",) mesh of the caller's group: schedule "ring" when the group has
one rank a node, else "gather" (one rank outside a group).  The fit runs
the ``megakernel`` backend: on the card one ``csvm_block_update`` launch
a round.  The torch counterpart of ``examples/decentralized_head.py``.

    PYTHONPATH=src python3 -m repro_torch.launch.decentralized_head
    PYTHONPATH=src python3 -m repro_torch.launch.decentralized_head --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import ADMMConfig, metrics
from repro_torch.core.admm import resolve_device
from repro_torch.core.decentral import decsvm_fit_sharded
from repro_torch.core.graph import ring
from repro_torch.launch.mesh import make_node_mesh
from repro_torch.models import model
from repro_torch.optim.decsvm_head import extract_features, standardize


def hyperplane_labels(feats: np.ndarray, rng) -> np.ndarray:
    """The example's private labels: a sparse hyperplane in feature space
    (10 coordinates drawn from ``rng``) with 5% of the signs flipped.
    feats: (m, n, d) -> (m, n) float32 in {-1, +1}."""
    w_true = np.zeros(feats.shape[-1])
    w_true[:10] = rng.standard_normal(10)
    y = np.sign(np.einsum("mnd,d->mn", feats - feats.mean((0, 1)), w_true))
    return np.where(rng.random(y.shape) < 0.05, -y, y).astype(np.float32)


def run(device=None, log=print, m: int = 8, n: int = 60,
        S: int = 32) -> dict:
    """Extract features of m x n sequences of S tokens, label them by a
    sparse hyperplane with 5% flips, fit the head and print the example's
    lines through ``log``.  ``device`` defaults to CUDA (raises without a
    card).  Returns the accuracy, gap, support, schedule and B (numpy)."""
    dev = resolve_device(None, device)
    cfg = configs.get_reduced("qwen3_14b")
    params = model.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (m, n, S))

    log("extracting frozen-backbone features ...")
    feats = extract_features(params, cfg, toks.reshape(-1, S))
    feats = feats.reshape(m, n, -1)

    yl = hyperplane_labels(feats.cpu().numpy(), rng)

    X, _, _ = standardize(feats, dev)
    W = ring(m)
    acfg = ADMMConfig(lam=0.02, h=0.3, max_iter=400, backend="megakernel")
    mesh = make_node_mesh()
    ndev = mesh.shape["node"]
    schedule = "ring" if ndev == m else "gather"
    log(f"ranks={ndev} nodes={m} schedule={schedule} device={dev}")
    B = decsvm_fit_sharded(X, torch.as_tensor(yl, device=dev), W, acfg,
                           mesh=mesh, schedule=schedule).cpu().numpy()

    margins = np.einsum("mnp,mp->mn", X.cpu().numpy(), B)
    out = dict(accuracy=metrics.margin_accuracy(margins, yl),
               consensus_gap=metrics.consensus_gap(B),
               support=metrics.mean_support_size(B, 1e-4),
               schedule=schedule, B=B)
    log(f"train accuracy      : {out['accuracy']:.3f}")
    log(f"consensus gap       : {out['consensus_gap']:.2e}")
    log(f"mean support size   : {out['support']:.1f} of {X.shape[-1]}")
    log("communication/round : one (d_model+1)-vector per neighbour "
        "(never the data)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
